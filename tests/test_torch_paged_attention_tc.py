"""The Hopper design of the paged-attention kernel K1, emulated on the CPU.

The CUDA kernel has no interpret mode, so its arithmetic is emulated here in
plain PyTorch and held to the tolerances ``chip_smoke.py`` phase 3 holds the
card to:

- the tensor-core prefill / verify instance: 64-row tiles of the rows
  ``r = c*G + g`` in blocks of 128 rows, 64-key tiles read through the block
  table from each block's live range, S = Q Kᵀ in f32 from bf16 operands
  (int8 / fp8 codes widened to bf16 without rounding), ``k_scale`` times
  scale·log2 e applied to S's columns, exp2 from a running max that starts
  at -1e30, ``v_scale`` applied to P's columns before P is split into two
  bf16 terms, the output rounded to bf16 — within one bf16 step
  (``2e-4 + 2^-7·|plain|``) of the plain version at CPU-sized versions of
  phase 3's bf16 prefill shapes, and once of the JAX reference;
- the split-KV decode instance: each (sequence, kv-head)'s live range
  cut into ``splits`` even shares, each streamed in 32-key slices per warp
  with its own f32 online softmax (P split into two bf16 terms), the warps'
  and splits' partial results merged in order — one bf16 step of the plain
  version for bf16 q; the same arithmetic without the bf16 products within
  1e-5 in f32; 0 for rows with no live key, independent of the split count
  to f32 rounding;
- the narrow pools' exactness in bf16 and the scale applied after the
  product;
- ``plan``, which picks the instance from shapes and dtypes alone.

The card runs the same comparisons (``tests/test_torch_paged_attention.py::
test_cuda_kernel_vs_plain_on_the_card``, marked ``gpu``, and
``chip_smoke.py``).
"""
import inspect
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.paged_attention import quant as jquant
from repro.kernels.paged_attention.ref import (
    paged_prefill_attention_reference as j_prefill_ref)
from repro_torch.convert import to_tensor
from repro_torch.kernels.paged_attention import (
    decode_splits, paged_attention_reference,
    paged_prefill_attention_reference, plan, quantize)
from repro_torch.kernels.paged_attention.paged_attention import (
    CC_DV_TILES, DECODE_ROWS, H100_SMS, MIN_SPLIT_KEYS, TC_DV_TILES)

@pytest.fixture(autouse=True)
def _one_thread():
    """The emulations multiply many small tiles: one intra-op thread keeps
    them from contending for the cores with the other test workers (the
    count is restored after each test)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ONE_BF16_STEP = (2e-4, 2.0 ** -7)     # chip_smoke.py's bf16 tolerance
F32_ATOL = 1e-5
POOLS = {"bfloat16": torch.bfloat16, "float32": torch.float32,
         "int8": torch.int8, "fp8_e4m3": torch.float8_e4m3fn}
J_POOLS = {"int8": jnp.int8, "fp8_e4m3": jnp.float8_e4m3fn}
LOG2E = math.log2(math.e)


def make_case(seed, *, B, C, H, KH, D, DV, bs, NB, kv_lens, q_starts=None,
              q_dtype=torch.bfloat16, pool="bfloat16", null_fill=0.0):
    """Pools, tables and queries from numpy (every sequence its own
    shuffled blocks, dead table entries on the null block 0, which may be
    poisoned with ``null_fill``); int8 / fp8 pools quantized by ``quantize``
    with their scales."""
    rng = np.random.default_rng(seed)
    P = B * NB + 1
    k = rng.standard_normal((P, bs, KH, D)).astype(np.float32)
    v = rng.standard_normal((P, bs, KH, DV)).astype(np.float32)
    k[0], v[0] = null_fill, -null_fill
    tables = rng.permutation(np.arange(1, P)).reshape(B, NB).astype(np.int32)
    kv_lens = np.asarray(kv_lens, np.int32)
    live = (np.arange(NB)[None] * bs) < kv_lens[:, None]
    tables = np.where(live, tables, 0).astype(np.int32)
    q = rng.standard_normal((B, C, H, D)).astype(np.float32)
    c = {"q": torch.from_numpy(q).to(q_dtype),
         "tables": torch.from_numpy(tables),
         "kv_lens": torch.from_numpy(kv_lens),
         "q_starts": torch.from_numpy(np.asarray(
             kv_lens - 1 if q_starts is None else q_starts, np.int32)),
         "k_scale": None, "v_scale": None, "np": {"q": q, "k": k, "v": v}}
    kt, vt = torch.from_numpy(k), torch.from_numpy(v)
    if POOLS[pool] in (torch.int8, torch.float8_e4m3fn):
        c["k"], c["k_scale"] = quantize(kt, POOLS[pool])
        c["v"], c["v_scale"] = quantize(vt, POOLS[pool])
    else:
        c["k"], c["v"] = kt.to(POOLS[pool]), vt.to(POOLS[pool])
    return c


def key_range(kv_len, q_start, c_min, c_max, *, NB, bs, window):
    """(kv_end, lo, hi) as the kernel computes them: the live blocks'
    positions (past kv_len and the table end, or wholly left of the window,
    excluded), cut by causality at the last row and the window at the
    first."""
    j_hi = min(NB, -(-kv_len // bs)) if kv_len > 0 else 0
    j_lo = max(q_start - window + 1, 0) // bs if window > 0 else 0
    kv_end = min(kv_len, j_hi * bs)
    hi = min(kv_end, q_start + c_max + 1)
    lo = j_lo * bs
    if window > 0:
        lo = max(lo, q_start + c_min - window + 1)
    return kv_end, max(lo, 0), hi


def gather(c, b, kh, keys):
    """K and V rows of sequence b, kv-head kh at positions ``keys`` through
    the table: the stored values in f32 (int8 / fp8 codes exactly) and
    their scales (ones for an unquantized pool)."""
    bs = c["k"].shape[1]
    keys = torch.as_tensor(keys, dtype=torch.long)
    blk = c["tables"][b].long()[keys // bs]
    off = keys % bs
    k = c["k"][blk, off, kh].float()
    v = c["v"][blk, off, kh].float()
    if c["k_scale"] is None:
        ones = torch.ones(len(keys))
        return k, v, ones, ones
    return k, v, c["k_scale"][blk, off, kh], c["v_scale"][blk, off, kh]


def f32(x) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def prefill_tile_emulation(c, *, window=0, split_p=True):
    """The tensor-core instance's arithmetic for bf16 q: returns (B, C, H,
    DV) bf16.  Tiles a warpgroup skips (wholly outside its rows' keys)
    leave its state as it is, so they are not visited here either."""
    q = c["q"]
    B, C, H, D = q.shape
    KH, DV = c["v"].shape[2], c["v"].shape[3]
    bs, NB = c["k"].shape[1], c["tables"].shape[1]
    G, CG = H // KH, C * (H // KH)
    sl2 = f32(D ** -0.5) * f32(LOG2E)
    rows_blk = 128 if CG > 64 else 64
    out = torch.zeros((B, C, H, DV))
    for b in range(B):
        kv_len, q_start = int(c["kv_lens"][b]), int(c["q_starts"][b])
        for kh in range(KH):
            qr = q[b].float().reshape(C, KH, G, D)[:, kh].reshape(CG, D)
            o_rows = torch.zeros((CG, DV))
            for row0 in range(0, CG, rows_blk):
                last = min(row0 + rows_blk, CG) - 1
                kv_end, lo, hi = key_range(kv_len, q_start, row0 // G,
                                           last // G, NB=NB, bs=bs,
                                           window=window)
                for wr0 in range(row0, last + 1, 64):
                    rows = torch.arange(wr0, min(wr0 + 64, CG))
                    qpos = q_start + rows // G
                    qmin, qmax = int(qpos[0]), int(qpos[-1])
                    m = torch.full((len(rows),), -1e30)
                    l = torch.zeros(len(rows))
                    o = torch.zeros((len(rows), DV))
                    for t0 in range(lo, hi, 64):
                        if t0 > qmax or (window > 0 and
                                         t0 + 63 <= qmin - window):
                            continue
                        keys = torch.arange(t0, min(t0 + 64, hi))
                        k, v, ks, vs = gather(c, b, kh, keys)
                        s = (qr[rows] @ k.T) * (ks * sl2)[None, :]
                        live = (keys[None] < kv_end) & \
                            (keys[None] <= qpos[:, None])
                        if window > 0:
                            live &= keys[None] > qpos[:, None] - window
                        s = torch.where(live, s, torch.tensor(-math.inf))
                        mn = torch.maximum(m, s.amax(-1))
                        alpha = torch.exp2(m - mn)
                        p = torch.exp2(s - mn[:, None])
                        l = l * alpha + p.sum(-1)
                        pv = p * vs[None, :]
                        phi = pv.bfloat16().float()
                        acc = phi @ v
                        if split_p:
                            acc = acc + (pv - phi).bfloat16().float() @ v
                        o = o * alpha[:, None] + acc
                        m = mn
                    o_rows[rows] = o / torch.clamp(l, min=1e-30)[:, None]
            out[b, :, kh * G:(kh + 1) * G] = o_rows.reshape(C, G, DV)
    return out.bfloat16()


def decode_split_emulation(c, *, splits, window=0, warps=4, split_p=None):
    """The split-KV decode instance (C*G <= 8) in plain PyTorch: returns
    (B, C, H, DV) in q's dtype.  ``split_p`` (by default: bf16 q over a
    narrow pool, which the instance takes) splits P into two bf16 terms
    before P V, as the ``mma.sync`` products take bf16 operands; without it
    (f32 inputs) the split-and-combine arithmetic is held alone."""
    if split_p is None:
        split_p = c["q"].dtype == torch.bfloat16 and \
            c["k"].dtype != torch.float32
    q = c["q"]
    B, C, H, D = q.shape
    KH, DV = c["v"].shape[2], c["v"].shape[3]
    bs, NB = c["k"].shape[1], c["tables"].shape[1]
    G, R = H // KH, C * (H // KH)
    sl2 = f32(D ** -0.5) * f32(LOG2E)
    out = torch.zeros((B, C, H, DV))
    for b in range(B):
        kv_len, q_start = int(c["kv_lens"][b]), int(c["q_starts"][b])
        kv_end, lo, hi = key_range(kv_len, q_start, 0, C - 1, NB=NB, bs=bs,
                                   window=window)
        per = -(-max(hi - lo, 0) // splits)
        qpos = q_start + torch.arange(R) // G
        for kh in range(KH):
            qr = q[b].float().reshape(C, KH, G, D)[:, kh].reshape(R, D)
            parts = []
            for s in range(splits):
                s_lo = lo + s * per
                s_hi = min(hi, s_lo + per)
                state = [(torch.full((R,), -1e30), torch.zeros(R),
                          torch.zeros((R, DV))) for _ in range(warps)]
                for t0 in range(s_lo, s_hi, 32 * warps):
                    for w in range(warps):
                        if t0 + 32 * w >= s_hi:
                            continue
                        keys = torch.arange(t0 + 32 * w,
                                            min(t0 + 32 * w + 32, s_hi))
                        m, l, acc = state[w]
                        k, v, ks, vs = gather(c, b, kh, keys)
                        x = (qr @ k.T) * (ks * sl2)[None, :]
                        live = (keys[None] < kv_end) & \
                            (keys[None] <= qpos[:, None])
                        if window > 0:
                            live &= keys[None] > qpos[:, None] - window
                        x = torch.where(live, x, torch.tensor(-math.inf))
                        mn = torch.maximum(m, x.amax(-1))
                        alpha = torch.exp2(m - mn)
                        p = torch.exp2(x - mn[:, None])
                        pv = p * vs[None, :]
                        if split_p:
                            phi = pv.bfloat16().float()
                            pvv = phi @ v + (pv - phi).bfloat16().float() @ v
                        else:
                            pvv = pv @ v
                        state[w] = (mn, l * alpha + p.sum(-1),
                                    acc * alpha[:, None] + pvv)
                ms = torch.stack([st[0] for st in state])
                mx = ms.amax(0)
                f = torch.exp2(ms - mx)
                parts.append((mx, (torch.stack([st[1] for st in state])
                                   * f).sum(0),
                              (torch.stack([st[2] for st in state])
                               * f[..., None]).sum(0)))
            mx = torch.stack([p[0] for p in parts]).amax(0)
            num, den = torch.zeros((R, DV)), torch.zeros(R)
            for m_s, l_s, a_s in parts:       # split order
                f = torch.exp2(m_s - mx)
                num = num + a_s * f[:, None]
                den = den + l_s * f
            o = num / torch.clamp(den, min=1e-30)[:, None]
            out[b, :, kh * G:(kh + 1) * G] = o.reshape(C, G, DV)
    return out.to(q.dtype)


def plain_prefill(c, window=0):
    return paged_prefill_attention_reference(
        c["q"], c["k"], c["v"], c["tables"], c["q_starts"], c["kv_lens"],
        window=window, k_scale=c["k_scale"], v_scale=c["v_scale"])


def excess(got, ref, tol) -> float:
    atol, rtol = tol
    err = (got.float() - ref.float()).abs()
    return float((err - (atol + rtol * ref.float().abs())).max())


def real_rows(c, valid):
    C = c["q"].shape[1]
    return torch.arange(C)[None, :] < torch.as_tensor(valid)[:, None]


def ragged(rng, n, lo, hi):
    return rng.integers(lo, hi + 1, size=n).astype(np.int32)


def _prefill_case(name):
    """CPU-sized versions of phase 3's bf16 prefill shapes: (case, window,
    valid tokens per sequence)."""
    rng = np.random.default_rng(7)
    tl = dict(H=16, KH=2, D=64, DV=64)
    if name.startswith("pruned"):
        pool = name.split("-")[1]
        st, va = np.array([0, 13, 40, 77], np.int32), \
            np.array([9, 4, 0, 9], np.int32)
        return make_case(3, B=4, C=9, H=6, KH=2, D=48, DV=40, bs=4, NB=24,
                         kv_lens=st + va, q_starts=st, pool=pool), 10, va
    if name.startswith("wide"):
        pool = name.split("-")[1]
        return make_case(4, B=2, C=40, H=2, KH=1, D=256, DV=200, bs=8,
                         NB=24, kv_lens=[80, 190], q_starts=[40, 150],
                         pool=pool), 0, np.array([40, 40], np.int32)
    C = {"C9": 9, "C13": 13, "C24": 24}.get(name.split("-")[0], 16)
    bs, NB = {"bs4": (4, 80), "bs8": (8, 40)}.get(name.split("-")[-1],
                                                   (16, 20))
    st = (ragged(rng, 4, 0, 16) * 16).astype(np.int32)
    va = ragged(rng, 4, 1, C)
    st[0], va[0] = 0, 0                  # a wholly idle row: kv_len 0
    va[1] = C
    va[2], st[2] = 0, 96                 # no new tokens over a history
    pool = "bfloat16"
    for p in ("int8", "fp8_e4m3"):
        if p in name:
            pool = p
    window = 48 if "win" in name else 0
    null = 1e4 if "null" in name else 0.0
    return make_case(5, B=4, C=C, bs=bs, NB=NB, kv_lens=st + va,
                     q_starts=st, pool=pool, null_fill=null, **tl), \
        window, va


PREFILL_CASES = ["C16-bfloat16", "C16-int8", "C16-fp8_e4m3",
                 "C16-int8-win", "C16-fp8_e4m3-win", "C24-bfloat16-null",
                 "C9-bfloat16-null", "C13-bfloat16", "C16-bfloat16-bs4",
                 "C16-int8-bs8", "pruned-bfloat16", "pruned-int8",
                 "pruned-fp8_e4m3", "wide-bfloat16", "wide-int8"]


@pytest.mark.parametrize("name", PREFILL_CASES)
def test_prefill_tile_emulation_within_one_bf16_step(name):
    """(a) The tensor-core design, emulated, against the plain version
    within one bf16 step on the rows that stand for real tokens; a row of a
    sequence with kv_len 0 comes out as exactly 0; every value finite (the
    poisoned null block never leaks)."""
    c, window, valid = _prefill_case(name)
    G = c["q"].shape[2] // c["k"].shape[2]
    assert plan(*c["q"].shape[:2], c["q"].shape[2], c["k"].shape[2],
                c["q"].shape[3], c["v"].shape[3], c["k"].shape[1],
                c["tables"].shape[1], torch.bfloat16,
                c["k"].dtype).instance == "wgmma"
    got = prefill_tile_emulation(c, window=window)
    ref = plain_prefill(c, window=window)
    assert torch.isfinite(got.float()).all()
    rows = real_rows(c, valid)
    assert excess(got[rows], ref[rows], ONE_BF16_STEP) <= 0, name
    idle = c["kv_lens"] == 0
    assert idle.any() == (not name.startswith(("pruned", "wide")))
    assert torch.equal(got[idle].float(), torch.zeros_like(got[idle].float()))
    assert c["q"].shape[1] * G > DECODE_ROWS


def test_prefill_emulation_vs_jax_reference():
    """(a) One case against the JAX package's plain version on the same
    numpy inputs: int8 pools quantized by the JAX package, so both read the
    same bytes."""
    c, window, valid = _prefill_case("C16-int8-win")
    n = c["np"]
    jk, jks = jquant.quantize(jnp.asarray(n["k"]), jnp.int8)
    jv, jvs = jquant.quantize(jnp.asarray(n["v"]), jnp.int8)
    for name, a in (("k", jk), ("k_scale", jks), ("v", jv), ("v_scale", jvs)):
        c[name] = to_tensor(np.asarray(a))
    jq = jnp.asarray(c["q"].float().numpy()).astype(jnp.bfloat16)
    ref = np.asarray(j_prefill_ref(
        jq, jk, jv, jnp.asarray(c["tables"].numpy()),
        jnp.asarray(c["q_starts"].numpy()), jnp.asarray(c["kv_lens"].numpy()),
        window=window, k_scale=jks, v_scale=jvs).astype(jnp.float32))
    got = prefill_tile_emulation(c, window=window)
    rows = real_rows(c, valid)
    assert excess(got[rows], torch.from_numpy(ref)[rows], ONE_BF16_STEP) <= 0


def test_one_bf16_rounding_of_p_would_not_fit_here_either():
    """(a) Why P is split into hi + lo in K1 too: one bf16 rounding of p
    misses the tolerance at the main path's prefill shape."""
    rng = np.random.default_rng(2)
    st = (ragged(rng, 2, 2, 6) * 64).astype(np.int32)
    c = make_case(8, B=2, C=64, H=8, KH=1, D=64, DV=64, bs=16, NB=32,
                  kv_lens=st + 64, q_starts=st)
    ref = plain_prefill(c)
    assert excess(prefill_tile_emulation(c, split_p=False), ref,
                  ONE_BF16_STEP) > 0
    assert excess(prefill_tile_emulation(c), ref, ONE_BF16_STEP) <= 0


def test_narrow_codes_are_exact_in_bf16():
    """(b) Every int8 value and every fp8-e4m3 value survives a round trip
    through bf16 exactly (the tensor-core instance widens the stored bytes
    to bf16 without rounding)."""
    i8 = torch.arange(-128, 128, dtype=torch.int16).to(torch.int8)
    assert torch.equal(i8.float().bfloat16().float(), i8.float())
    f8 = torch.arange(256, dtype=torch.int16).to(torch.uint8).view(
        torch.float8_e4m3fn).float()
    back = f8.bfloat16().float()
    assert torch.equal(torch.isnan(back), torch.isnan(f8))
    ok = ~torch.isnan(f8)
    assert torch.equal(back[ok], f8[ok]) and ok.sum() == 254


@pytest.mark.parametrize("pool", ["int8", "fp8_e4m3"])
def test_scale_after_the_product_is_dequantize_then_multiply(pool):
    """(b) q·(code)·scale, the scale applied after the product, equals the
    plain version's q·(code·scale) to f32 rounding: both within a few f32
    steps of the float64 value, relative to Σ|terms|."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((512, 64)).astype(np.float32))
    codes, scale = quantize(x, POOLS[pool])
    q = torch.from_numpy(rng.standard_normal((64,)).astype(np.float32)
                         ).bfloat16().float()
    after = (codes.float() @ q) * scale
    before = (codes.float() * scale[:, None]) @ q
    exact = (codes.double() * scale.double()[:, None]) @ q.double()
    size = (codes.double().abs() * scale.double()[:, None]) @ q.double().abs()
    eps = 2.0 ** -24
    for got in (after, before):
        assert float(((got.double() - exact).abs() / size).max()) < 70 * eps
    assert float(((after.double() - before.double()).abs()
                  / size).max()) < 140 * eps


DECODE_CASES = {
    # (B, H, KH, D, DV, bs, NB, kv_lens, window)
    "gqa-ragged": (4, 16, 2, 64, 64, 16, 24, [1, 100, 383, 250], 0),
    "long-beside-idle": (3, 16, 2, 64, 64, 16, 128, [2048, 0, 1], 0),
    "window": (3, 8, 2, 64, 64, 16, 64, [1000, 40, 301], 100),
    "pruned": (3, 6, 2, 48, 40, 4, 40, [1, 77, 160], 0),
    "wide": (2, 4, 2, 256, 200, 8, 32, [250, 9], 0),
}


@pytest.mark.parametrize("dt,pool", [
    (torch.float32, "float32"), (torch.bfloat16, "bfloat16"),
    (torch.bfloat16, "int8"), (torch.float32, "fp8_e4m3"),
    (torch.float32, "bfloat16")], ids=lambda x: str(x).replace("torch.", ""))
@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_split_kv_decode_emulation(case, dt, pool):
    """(c) Split-KV decode and its combine, emulated, against the plain
    version: 1e-5 in f32, one bf16 step in bf16; 0 for kv_len 0 rows; the
    split count of the tensor-core plan, and 1 and 7 splits, all agree to
    f32 rounding (7 splits over a short row leave splits with no live key).
    f32 q or an f32 pool takes the CUDA-core instance on the card; there the
    emulation holds the split arithmetic alone, at 1e-5."""
    B, H, KH, D, DV, bs, NB, lens, window = DECODE_CASES[case]
    c = make_case(9, B=B, C=1, H=H, KH=KH, D=D, DV=DV, bs=bs, NB=NB,
                  kv_lens=lens, q_dtype=dt, pool=pool, null_fill=1e4)
    ref = paged_attention_reference(
        c["q"][:, 0], c["k"], c["v"], c["tables"], c["kv_lens"],
        window=window, k_scale=c["k_scale"], v_scale=c["v_scale"])[:, None]
    pl = plan(B, 1, H, KH, D, DV, bs, NB, dt, c["k"].dtype)
    tc = dt == torch.bfloat16 and c["k"].dtype != torch.float32
    assert pl.instance == ("split_kv_mma" if tc else "cuda_core")
    assert DV <= pl.dv_tile
    n = decode_splits(B, KH, NB, bs)
    outs = {s: decode_split_emulation(c, splits=s, window=window)
            for s in sorted({1, 7, n})}
    tol = (F32_ATOL, 0.0) if dt == torch.float32 else ONE_BF16_STEP
    live = c["kv_lens"] > 0
    for s, got in outs.items():
        assert torch.isfinite(got.float()).all()
        assert excess(got[live], ref[live], tol) <= 0, s
        assert torch.equal(got[~live].float(),
                           torch.zeros_like(got[~live].float()))
    if dt == torch.float32:
        a, b = outs[1], outs[7]
        assert float((a - b).abs().max()) <= 2e-6 * max(
            1.0, float(a.abs().max()))


def test_split_kv_prefill_rows_of_a_small_chunk():
    """(c) The decode instance also takes prefill / verify chunks of at most
    8 rows (C 3, G 2 here, a partial chunk): each row masks at its own
    position (the split arithmetic alone, at 1e-5 in f32)."""
    c = make_case(12, B=2, C=3, H=4, KH=2, D=32, DV=32, bs=8, NB=16,
                  kv_lens=[40, 127], q_starts=[37, 125],
                  q_dtype=torch.float32, pool="float32")
    ref = plain_prefill(c)
    got = decode_split_emulation(c, splits=3)
    rows = real_rows(c, [3, 2])
    assert excess(got[rows], ref[rows], (F32_ATOL, 0.0)) <= 0


Q_TYPES = (torch.float32, torch.bfloat16)
KV_TYPES = tuple(POOLS.values())


def test_plan_maps_every_accepted_input_to_an_instance():
    """(d) Every (q dtype, pool dtype, C·G, D, DV) the wrapper accepts: bf16
    q over a bf16 / int8 / fp8 pool on the tensor cores (``mma.sync`` for
    decode, ``wgmma`` with two warpgroups a block past 64 rows for prefill),
    f32 q or an f32 pool on the CUDA cores at any row count; at most 8 rows
    on the tensor cores -> the split-KV decode instance; the accumulator the
    narrowest that holds DV."""
    for qd in Q_TYPES:
        for kd in KV_TYPES:
            for C, H, KH in ((1, 8, 1), (1, 32, 4), (3, 2, 1), (8, 1, 1),
                             (9, 8, 1), (9, 6, 2), (128, 32, 4), (13, 5, 1),
                             (40, 2, 1), (64, 1, 1), (65, 1, 1)):
                rows = C * (H // KH)
                for D in (1, 16, 48, 64, 200, 256):
                    for DV in range(1, 257, 13):
                        pl = plan(4, C, H, KH, D, DV, 16, 8, qd, kd)
                        tc = qd == torch.bfloat16 and kd != torch.float32
                        tiles = TC_DV_TILES if tc else CC_DV_TILES
                        if not tc:
                            assert pl.instance == "cuda_core"
                            assert pl.splits == 0 and pl.warpgroups == 0
                        elif rows <= DECODE_ROWS:
                            assert pl.instance == "split_kv_mma"
                            assert pl.splits >= 1 and pl.warpgroups == 0
                        else:
                            assert pl.instance == "wgmma"
                            assert pl.warpgroups == (2 if rows > 64 else 1)
                        assert pl.dv_tile == min(t for t in tiles if DV <= t)


def test_split_count_depends_on_shapes_alone():
    """(d) The split count is a function of (B, KH, NB, bs) and the SM
    count: no length enters ``plan`` (so a serving step reads nothing back
    from the card), nor do H, C, D, DV or the narrow pool's dtype change
    it.  At most three blocks an SM in all, with at least MIN_SPLIT_KEYS
    table positions a split."""
    assert list(inspect.signature(plan).parameters) == [
        "B", "C", "H", "KH", "D", "DV", "bs", "NB", "q_dtype", "kv_dtype",
        "sm_count"]
    for B, KH, NB, bs in ((32, 4, 80, 16), (3, 4, 128, 16), (1, 1, 512, 4),
                          (64, 8, 16, 16), (5, 2, 40, 4)):
        n = decode_splits(B, KH, NB, bs)
        assert {plan(B, C, H, KH, D, DV, bs, NB, torch.bfloat16, kd).splits
                for C, H in ((1, KH), (1, 8 * KH), (2, 4 * KH))
                for D, DV in ((64, 64), (48, 40), (256, 200))
                for kd in KV_TYPES if kd != torch.float32} == {n}
        assert 1 <= n <= max(1, NB * bs // MIN_SPLIT_KEYS)
        assert n == 1 or B * KH * n <= 3 * H100_SMS
        assert n == max(1, NB * bs // MIN_SPLIT_KEYS) or \
            B * KH * (n + 1) > 3 * H100_SMS
    assert decode_splits(32, 4, 80, 16) == 3       # the main path: 384 blocks
    assert decode_splits(3, 4, 128, 16) == 8       # one long sequence
    assert decode_splits(3, 4, 128, 16, sm_count=16) == 4
