"""PyTorch port vs JAX reference: the paged-attention sub-package.

The port's plain version (``ref.py``) is held against the JAX ``ref.py`` and
against the Pallas kernel run in interpret mode, on identical pools, tables
and queries made with numpy; ``quantize`` is held bit for bit; and
``expected_visits`` against the interpret kernel's visit counter.  The CUDA
kernel itself cannot run without a GPU: its test is marked ``gpu`` and
skips here (``python3 chip_smoke.py`` makes the same comparison on the
card).  f32, tolerance 1e-5 absolute (summation order differs).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.paged_attention import quant as jquant
from repro.kernels.paged_attention.paged_attention import (
    paged_attention_kernel as j_decode_kernel,
    paged_prefill_attention_kernel as j_prefill_kernel)
from repro.kernels.paged_attention.ref import (
    paged_attention_reference as j_decode_ref,
    paged_prefill_attention_reference as j_prefill_ref)
from repro_torch import convert
from repro_torch.kernels.paged_attention import (
    CACHE_DTYPES, dequantize, expected_visits, is_quantized,
    paged_attention, paged_attention_kernel, paged_prefill_attention,
    pool_dtype, quantize)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ATOL = 1e-5
J_DTYPE = {"int8": jnp.int8, "fp8_e4m3": jnp.float8_e4m3fn}
T_DTYPE = {"int8": torch.int8, "fp8_e4m3": torch.float8_e4m3fn}


def make_case(seed, *, B, C, H, KH, D, DV, bs, NB, kv_lens, q_starts=None,
              pool="float32", null_fill=0.0):
    """numpy inputs + the same inputs as jnp arrays and as tensors."""
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
    j = {"q": jnp.asarray(q), "tables": jnp.asarray(tables),
         "kv_lens": jnp.asarray(kv_lens), "k_scale": None, "v_scale": None}
    t = {"q": torch.from_numpy(q), "tables": torch.from_numpy(tables),
         "kv_lens": torch.from_numpy(kv_lens), "k_scale": None,
         "v_scale": None}
    if q_starts is not None:
        qs = np.asarray(q_starts, np.int32)
        j["q_starts"], t["q_starts"] = jnp.asarray(qs), torch.from_numpy(qs)
    if pool in J_DTYPE:
        j["k"], j["k_scale"] = jquant.quantize(jnp.asarray(k), J_DTYPE[pool])
        j["v"], j["v_scale"] = jquant.quantize(jnp.asarray(v), J_DTYPE[pool])
        # the port reads the very bytes JAX wrote
        for n in ("k", "v", "k_scale", "v_scale"):
            t[n] = convert.to_tensor(np.asarray(j[n]))
    else:
        j["k"], j["v"] = jnp.asarray(k), jnp.asarray(v)
        t["k"], t["v"] = torch.from_numpy(k), torch.from_numpy(v)
    return j, t


def _scales(c):
    return dict(k_scale=c["k_scale"], v_scale=c["v_scale"])


DECODE_CASES = {
    "gqa-ragged": dict(B=4, H=8, KH=2, D=16, DV=16, bs=4, NB=8,
                       kv_lens=[1, 7, 20, 32]),
    "mha": dict(B=2, H=4, KH=4, D=16, DV=16, bs=8, NB=4, kv_lens=[9, 32]),
    "d-ne-dv": dict(B=3, H=6, KH=2, D=24, DV=40, bs=4, NB=10,
                    kv_lens=[3, 18, 40]),
    "null-block-large": dict(B=3, H=4, KH=1, D=16, DV=16, bs=4, NB=8,
                             kv_lens=[2, 5, 30], null_fill=1e4),
}


@pytest.mark.parametrize("window", [0, 5], ids=["full", "win5"])
@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_decode_plain_vs_jax_ref_and_interpret_kernel(case, window):
    j, t = make_case(11, C=1, **DECODE_CASES[case])
    ref = np.asarray(j_decode_ref(j["q"][:, 0], j["k"], j["v"], j["tables"],
                                  j["kv_lens"], window=window))
    ker, visits = j_decode_kernel(j["q"][:, 0], j["k"], j["v"], j["tables"],
                                  j["kv_lens"], window=window,
                                  interpret=True, return_visits=True)
    got = paged_attention(t["q"][:, 0], t["k"], t["v"], t["tables"],
                          t["kv_lens"], window=window).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got, np.asarray(ker), atol=ATOL, rtol=0)
    want = expected_visits(t["kv_lens"] - 1, t["kv_lens"],
                           t["tables"].shape[1], t["k"].shape[1], window)
    KH = t["k"].shape[2]
    np.testing.assert_array_equal(np.asarray(visits),
                                  want[:, None].expand(-1, KH).numpy())


PREFILL_CASES = {
    # ragged valid incl. 0, a partial last chunk, non-zero q_starts
    "gqa-ragged": dict(B=4, C=6, H=8, KH=2, D=16, DV=16, bs=4, NB=10,
                       q_starts=[0, 8, 13, 20], valid=[6, 0, 3, 5]),
    "d-ne-dv": dict(B=2, C=5, H=6, KH=2, D=24, DV=40, bs=4, NB=8,
                    q_starts=[4, 17], valid=[5, 2]),
    "null-block-large": dict(B=3, C=4, H=4, KH=1, D=16, DV=16, bs=4, NB=8,
                             q_starts=[0, 6, 12], valid=[4, 1, 3],
                             null_fill=1e4),
}


def _real_rows(valid, C):
    return np.arange(C)[None, :] < np.asarray(valid)[:, None]


@pytest.mark.parametrize("window", [0, 5], ids=["full", "win5"])
@pytest.mark.parametrize("case", sorted(PREFILL_CASES))
def test_prefill_plain_vs_jax_ref_and_interpret_kernel(case, window):
    spec = dict(PREFILL_CASES[case])
    valid = spec.pop("valid")
    lens = np.asarray(spec["q_starts"]) + np.asarray(valid)
    j, t = make_case(12, kv_lens=lens, **spec)
    args_j = (j["q"], j["k"], j["v"], j["tables"], j["q_starts"],
              j["kv_lens"])
    ref = np.asarray(j_prefill_ref(*args_j, window=window))
    ker, visits = j_prefill_kernel(*args_j, window=window, interpret=True,
                                   return_visits=True)
    got = paged_prefill_attention(t["q"], t["k"], t["v"], t["tables"],
                                  t["q_starts"], t["kv_lens"],
                                  window=window).numpy()
    # the two plain versions are the same function on every row, padding too
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)
    # the kernel is held on the rows that stand for real tokens
    rows = _real_rows(valid, spec["C"])
    np.testing.assert_allclose(got[rows], np.asarray(ker)[rows], atol=ATOL,
                               rtol=0)
    assert np.isfinite(got).all()
    want = expected_visits(t["q_starts"], t["kv_lens"], t["tables"].shape[1],
                           t["k"].shape[1], window)
    KH = t["k"].shape[2]
    np.testing.assert_array_equal(np.asarray(visits),
                                  want[:, None].expand(-1, KH).numpy())


@pytest.mark.parametrize("entry", ["decode", "prefill"])
def test_tensor_window_per_sequence(entry):
    """A (B,) window (hybrid layers) goes through the plain version on both
    sides; 0 entries mean full attention."""
    win = np.asarray([0, 3, 9], np.int32)
    if entry == "decode":
        j, t = make_case(13, B=3, C=1, H=4, KH=2, D=16, DV=16, bs=4, NB=8,
                         kv_lens=[12, 20, 31])
        ref = j_decode_ref(j["q"][:, 0], j["k"], j["v"], j["tables"],
                           j["kv_lens"], window=jnp.asarray(win))
        got = paged_attention(t["q"][:, 0], t["k"], t["v"], t["tables"],
                              t["kv_lens"], window=torch.from_numpy(win))
    else:
        j, t = make_case(13, B=3, C=4, H=4, KH=2, D=16, DV=16, bs=4, NB=8,
                         kv_lens=[12, 20, 31], q_starts=[8, 16, 27])
        ref = j_prefill_ref(j["q"], j["k"], j["v"], j["tables"],
                            j["q_starts"], j["kv_lens"],
                            window=jnp.asarray(win))
        got = paged_prefill_attention(
            t["q"], t["k"], t["v"], t["tables"], t["q_starts"], t["kv_lens"],
            window=torch.from_numpy(win))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("pool", ["int8", "fp8_e4m3"])
@pytest.mark.parametrize("entry", ["decode", "prefill"])
def test_quantized_pools_vs_jax(entry, pool):
    """Same stored bytes and scales on both sides; the fused-dequant Pallas
    kernel (interpret) and both plain versions agree."""
    if entry == "decode":
        j, t = make_case(14, B=3, C=1, H=8, KH=2, D=16, DV=24, bs=4, NB=8,
                         kv_lens=[5, 17, 32], pool=pool)
        ref = j_decode_ref(j["q"][:, 0], j["k"], j["v"], j["tables"],
                           j["kv_lens"], **_scales(j))
        ker = j_decode_kernel(j["q"][:, 0], j["k"], j["v"], j["tables"],
                              j["kv_lens"], interpret=True, **_scales(j))
        got = paged_attention(t["q"][:, 0], t["k"], t["v"], t["tables"],
                              t["kv_lens"], **_scales(t)).numpy()
        rows = np.ones(3, bool)
    else:
        valid = [4, 2, 0]
        j, t = make_case(14, B=3, C=4, H=8, KH=2, D=16, DV=24, bs=4, NB=8,
                         kv_lens=[12, 18, 24], q_starts=[8, 16, 24],
                         pool=pool)
        args_j = (j["q"], j["k"], j["v"], j["tables"], j["q_starts"],
                  j["kv_lens"])
        ref = j_prefill_ref(*args_j, **_scales(j))
        ker = j_prefill_kernel(*args_j, interpret=True, **_scales(j))
        got = paged_prefill_attention(
            t["q"], t["k"], t["v"], t["tables"], t["q_starts"],
            t["kv_lens"], **_scales(t)).numpy()
        rows = _real_rows(valid, 4)
    np.testing.assert_allclose(got, np.asarray(ref), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got[rows], np.asarray(ker)[rows], atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("pool", ["int8", "fp8_e4m3"])
def test_quantize_bits_and_scales_equal_jax(pool):
    rng = np.random.default_rng(15)
    x = rng.standard_normal((6, 5, 3, 24)).astype(np.float32) * 7
    x[0, 0, 0] = 0.0                          # all-zero vector: scale 0
    x[1, 1, 1, :4] = [0.5, 1.5, 2.5, -3.5]    # ties for round-half-even
    x[1, 1, 1, 4] = 127.0                     # absmax 127 -> scale 1 (int8)
    jq, js = jquant.quantize(jnp.asarray(x), J_DTYPE[pool])
    tq, ts = quantize(torch.from_numpy(x), T_DTYPE[pool])
    assert tq.dtype == pool_dtype(pool)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        convert.to_numpy(tq).view(np.uint8),
        np.asarray(jq).view(np.uint8))
    back_j = np.asarray(jquant.dequantize(jq, js))
    back_t = dequantize(tq, ts).numpy()
    np.testing.assert_array_equal(back_t, back_j)
    assert np.isfinite(back_t).all() and np.all(back_t[0, 0, 0] == 0)


def test_quant_tables_match_reference():
    assert CACHE_DTYPES == jquant.CACHE_DTYPES
    for name in CACHE_DTYPES:
        assert is_quantized(name) == jquant.is_quantized(name)
    assert not is_quantized(None)


@pytest.mark.parametrize("bs,window", [(4, 0), (4, 3), (4, 7), (16, 20),
                                       (8, 1)])
def test_expected_visits_is_the_block_live_count(bs, window):
    """Brute force of the reference's ``_block_live`` over every block."""
    rng = np.random.default_rng(16)
    NB = 12
    q_starts = rng.integers(-1, NB * bs, size=40)
    kv_lens = np.clip(q_starts + rng.integers(0, 9, size=40), 0, NB * bs + 5)
    want = []
    for qs, kl in zip(q_starts, kv_lens):
        n = 0
        for jb in range(NB):
            first = jb * bs
            live = first < kl
            if window:
                live = live and first + bs - 1 > qs - window
            n += bool(live)
        want.append(n)
    got = expected_visits(q_starts, kv_lens, NB, bs, window)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_return_visits_on_plain_path_raises():
    _, t = make_case(17, B=2, C=2, H=2, KH=1, D=16, DV=16, bs=4, NB=4,
                     kv_lens=[3, 9], q_starts=[1, 7])
    with pytest.raises(ValueError, match="kernel-path observable"):
        paged_attention(t["q"][:, 0], t["k"], t["v"], t["tables"],
                        t["kv_lens"], return_visits=True)
    with pytest.raises(ValueError, match="kernel-path observable"):
        paged_prefill_attention(t["q"], t["k"], t["v"], t["tables"],
                                t["q_starts"], t["kv_lens"],
                                return_visits=True)


def test_kernel_wrapper_refuses_cpu_tensors():
    """The wrapper launches on CUDA tensors or raises — it has no plain
    fallback of its own."""
    _, t = make_case(18, B=2, C=1, H=2, KH=1, D=16, DV=16, bs=4, NB=4,
                     kv_lens=[3, 9])
    with pytest.raises(ValueError, match="CUDA tensors"):
        paged_attention_kernel(t["q"][:, 0], t["k"], t["v"], t["tables"],
                               t["kv_lens"])


class _OnTheCard:
    """Stands for a CUDA tensor where only the dispatch is under test."""
    is_cuda = True


@pytest.mark.parametrize("entry", ["decode", "prefill"])
@pytest.mark.parametrize("window", [0, 5, np.int64(5), np.int32(0), "tensor",
                                    2.5])
def test_cuda_tensors_reach_the_kernel_or_raise(monkeypatch, entry, window):
    """For tensors on the card the dispatch has one way out: the kernel
    wrapper.  Any integer type arrives there as a python int, a tensor
    window raises, and the plain version is never called."""
    from repro_torch.kernels.paged_attention import ops
    seen = {}

    def kernel(*args, window, **kw):
        seen["window"] = window
        if not isinstance(window, int):
            raise TypeError("static python-int window")
        return "kernel"

    def plain(*args, **kw):
        raise AssertionError("the plain version was given CUDA tensors")

    monkeypatch.setattr(ops, "paged_attention_kernel", kernel)
    monkeypatch.setattr(ops, "paged_prefill_attention_kernel", kernel)
    monkeypatch.setattr(ops, "paged_attention_reference", plain)
    monkeypatch.setattr(ops, "paged_prefill_attention_reference", plain)
    fn = ops.paged_attention if entry == "decode" \
        else ops.paged_prefill_attention
    args = (_OnTheCard(),) + (None,) * (4 if entry == "decode" else 5)
    if isinstance(window, str):
        with pytest.raises(NotImplementedError,
                           match="plain version on CPU tensors only"):
            fn(*args, window=torch.tensor([0, 3], dtype=torch.int32))
        assert not seen
    elif isinstance(window, float):
        with pytest.raises(TypeError):
            fn(*args, window=window)
    else:
        assert fn(*args, window=window) == "kernel"
        assert type(seen["window"]) is int and seen["window"] == int(window)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no interpret mode "
                    "(python3 chip_smoke.py makes this comparison on the "
                    "card)")
    return torch.device("cuda")


# (entry, q dtype, pool, case kwargs, valid rows per sequence, window):
# every instance the wrapper plans — split-KV decode and prefill on the
# tensor cores, the CUDA-core instance at prefill and decode — at f32 and
# bf16, bf16 / int8 / fp8 pools
CARD_CASES = [
    ("prefill", "float32", "float32",
     dict(B=4, C=6, H=8, KH=2, D=24, DV=40, bs=4, NB=10,
          kv_lens=[6, 8, 16, 25], q_starts=[0, 8, 13, 20]), [6, 0, 3, 5], 0),
    ("prefill", "bfloat16", "bfloat16",
     dict(B=3, C=20, H=8, KH=1, D=64, DV=64, bs=16, NB=8,
          kv_lens=[0, 70, 120], q_starts=[0, 50, 100], null_fill=1e4),
     [0, 20, 20], 0),
    ("prefill", "bfloat16", "int8",
     dict(B=2, C=9, H=6, KH=2, D=48, DV=40, bs=4, NB=24,
          kv_lens=[9, 80], q_starts=[0, 71]), [9, 9], 10),
    ("prefill", "bfloat16", "fp8_e4m3",
     dict(B=2, C=40, H=2, KH=1, D=256, DV=200, bs=8, NB=24,
          kv_lens=[80, 190], q_starts=[40, 150]), [40, 40], 0),
    ("decode", "bfloat16", "bfloat16",
     dict(B=3, C=1, H=32, KH=4, D=64, DV=64, bs=16, NB=128,
          kv_lens=[2048, 0, 1], null_fill=1e4), None, 0),
    ("decode", "float32", "int8",
     dict(B=4, C=1, H=8, KH=2, D=16, DV=16, bs=4, NB=8,
          kv_lens=[1, 7, 20, 32]), None, 5),
]


def _bits(t):
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def _card_case(seed, device, *, q_dtype, pool, B, C, H, KH, D, DV, bs, NB,
               kv_lens, q_starts=None, null_fill=0.0):
    """``make_case``'s pools, tables and queries built with torch alone (the
    port's ``quantize``), so that the card needs no JAX for them."""
    rng = np.random.default_rng(seed)
    P = B * NB + 1
    k = torch.from_numpy(rng.standard_normal((P, bs, KH, D), np.float32))
    v = torch.from_numpy(rng.standard_normal((P, bs, KH, DV), np.float32))
    k[0], v[0] = null_fill, -null_fill
    tables = rng.permutation(np.arange(1, P)).reshape(B, NB).astype(np.int32)
    lens = np.asarray(kv_lens, np.int32)
    live = (np.arange(NB)[None] * bs) < lens[:, None]
    t = {"q": torch.from_numpy(rng.standard_normal((B, C, H, D), np.float32)
                               ).to(getattr(torch, q_dtype)),
         "tables": torch.from_numpy(np.where(live, tables, 0).astype(
             np.int32)), "kv_lens": torch.from_numpy(lens),
         "q_starts": torch.from_numpy(np.asarray(
             lens - 1 if q_starts is None else q_starts, np.int32)),
         "k_scale": None, "v_scale": None}
    if pool in T_DTYPE:
        t["k"], t["k_scale"] = quantize(k, T_DTYPE[pool])
        t["v"], t["v_scale"] = quantize(v, T_DTYPE[pool])
    else:
        t["k"], t["v"] = k.to(getattr(torch, pool)), v.to(getattr(torch, pool))
    return {n: None if x is None else x.to(device) for n, x in t.items()}


@pytest.mark.gpu
def test_cuda_kernel_vs_plain_on_the_card(cuda_device):
    """Each instance against the plain version: 1e-5 in f32, one bf16 step
    (``2e-4 + 2^-7·|plain|``) in bf16, on the rows that stand for real
    tokens; visit counts exact; a second call bitwise equal; kv_len 0 rows
    are 0."""
    from repro_torch.kernels.paged_attention import plan
    seen = set()
    for i, (entry, qd, pool, kw, valid, window) in enumerate(CARD_CASES):
        t = _card_case(19 + i, cuda_device, q_dtype=qd, pool=pool, **kw)
        sc = _scales(t)
        if entry == "prefill":
            args = (t["q"], t["k"], t["v"], t["tables"], t["q_starts"],
                    t["kv_lens"])
            fn, starts = paged_prefill_attention, t["q_starts"]
        else:
            args = (t["q"][:, 0], t["k"], t["v"], t["tables"], t["kv_lens"])
            fn, starts = paged_attention, t["kv_lens"] - 1
        B, C, H, D = t["q"].shape
        _, bs, KH, DV = t["v"].shape
        seen.add(plan(B, C, H, KH, D, DV, bs, t["tables"].shape[1],
                      t["q"].dtype, t["k"].dtype).instance)
        out, visits = fn(*args, window=window, return_visits=True, **sc)
        again = fn(*args, window=window, **sc)
        torch.cuda.synchronize()
        assert torch.equal(_bits(out), _bits(again))
        ref = fn(*args, window=window, use_kernel=False, **sc)
        rows = (torch.from_numpy(_real_rows(valid, C)).to(cuda_device)
                if entry == "prefill" else t["kv_lens"] > 0)
        atol, rtol = (ATOL, 0.0) if qd == "float32" else (2e-4, 2.0 ** -7)
        err = (out.float() - ref.float()).abs()[rows]
        assert float((err - atol - rtol * ref.float().abs()[rows]).max()) \
            <= 0, (entry, qd, pool)
        idle = t["kv_lens"] == 0
        assert not out[idle].float().abs().any()
        want = expected_visits(starts.cpu(), t["kv_lens"].cpu(),
                               t["tables"].shape[1], bs, window)
        assert torch.equal(visits.cpu(), want[:, None].expand(-1, KH))
    assert seen == {"split_kv_mma", "wgmma", "cuda_core"}
