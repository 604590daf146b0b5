"""PyTorch port vs JAX reference: full-sequence flash attention (kernel K2).

The same numpy inputs (seeded) go through the port's plain version
(``ref.attention_reference``, and ``ops.flash_attention`` whose CPU route it
is) and through the JAX package's ``flash_attention_ref`` and its Pallas
``flash_attention`` in interpret mode, on the reference's grid
(``tests/test_kernels.py::test_flash_attention``) plus the OBSPA-pruned
TinyLlama's D 64 / DV 32 at S 200.  The tolerance is the reference's: 1e-5
for f32 and 3e-2 for bf16, absolute and relative.  The CUDA kernel itself
has no interpret mode: its comparison with the plain version is the
``gpu``-marked test below, and ``chip_smoke.py`` phase 10 on the card.

The bf16 tensor-core design is emulated here in plain PyTorch (64-key
tiles, scale·log2 e with exp2, a running max from -1e30, P split into two
bf16 terms before an f32-accumulated PV, the output rounded to bf16) and
held to phase 10's one-bf16-step tolerance at CPU-sized versions of its bf16
shapes; so is ``plan``, the wrapper's choice of instance and copy path.
"""
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.flash_attention import (
    flash_attention as j_flash_attention,
    flash_attention_ref as j_flash_attention_ref)
from repro_torch.convert import to_tensor
from repro_torch.kernels.flash_attention import (
    check_args, flash_attention, flash_attention_kernel, flash_attention_ref,
    plan)
from repro_torch.kernels.flash_attention.flash_attention import DV_TILES
from repro_torch.kernels.flash_attention.ref import attention_reference

# (B, S, H, KH, D, DV, causal, window, dtype): the reference's six shapes,
# then the pruned model's D != DV at a length that is not a multiple of the
# tile
SHAPES = {
    "B2-S128-H4-KH2-D32-causal-f32": (2, 128, 4, 2, 32, 32, True, 0, "f32"),
    "B1-S200-H4-KH1-D64-DV48-f32": (1, 200, 4, 1, 64, 48, True, 0, "f32"),
    "B2-S128-H8-KH8-D32-bidir-f32": (2, 128, 8, 8, 32, 32, False, 0, "f32"),
    "B1-S256-H4-KH2-D32-window64-f32": (1, 256, 4, 2, 32, 32, True, 64,
                                        "f32"),
    "B1-S128-H2-KH2-D64-bf16": (1, 128, 2, 2, 64, 64, True, 0, "bf16"),
    "B1-S96-H4-KH4-D16-window32-bf16": (1, 96, 4, 4, 16, 16, True, 32,
                                        "bf16"),
    "B2-S200-H4-KH2-D64-DV32-pruned-f32": (2, 200, 4, 2, 64, 32, True, 0,
                                           "f32"),
}
NP = {"f32": np.float32, "bf16": jnp.bfloat16}
TOL = {"f32": 1e-5, "bf16": 3e-2}


def make_case(seed, B, S, H, KH, D, DV, dt):
    """q (B, S, H, D), k (B, S, KH, D), v (B, S, KH, DV) in model layout,
    standard normal, rounded to the case's type."""
    rng = np.random.default_rng(seed)
    return [np.asarray(jnp.asarray(rng.normal(size=shape)).astype(NP[dt]))
            for shape in ((B, S, H, D), (B, S, KH, D), (B, S, KH, DV))]


def as_np(t) -> np.ndarray:
    return np.asarray(t.float() if isinstance(t, torch.Tensor) else t,
                      np.float32)


@pytest.mark.parametrize("case", sorted(SHAPES))
def test_plain_vs_jax_reference_and_interpret_kernel(case):
    B, S, H, KH, D, DV, causal, window, dt = SHAPES[case]
    arrs = make_case(1, B, S, H, KH, D, DV, dt)
    j = [jnp.asarray(a) for a in arrs]
    t = [to_tensor(a) for a in arrs]
    jref = j_flash_attention_ref(*j, causal=causal, window=window)
    jker = j_flash_attention(*j, causal=causal, window=window,
                             block_q=64, block_k=64)     # Pallas, interpret
    tol = TOL[dt]
    for got in (flash_attention(*t, causal=causal, window=window),
                flash_attention_ref(*t, causal=causal, window=window)):
        assert got.dtype == t[0].dtype and got.shape == (B, S, H, DV)
        for want in (jref, jker):
            np.testing.assert_allclose(as_np(got), as_np(want), rtol=tol,
                                       atol=tol)
    # the kernel layout (B, H, S, D) of the plain version, f32 logits
    bhsd = attention_reference(*[x.transpose(1, 2) for x in t],
                               causal=causal, window=window)
    np.testing.assert_array_equal(as_np(bhsd.transpose(1, 2)),
                                  as_np(flash_attention_ref(
                                      *t, causal=causal, window=window)))


def test_explicit_scale_and_cross_lengths_vs_jax():
    """A scale other than D^-1/2 and Sq != Sk (the masks then compare raw
    indices, as the reference's do)."""
    rng = np.random.default_rng(7)
    q = rng.normal(size=(2, 40, 6, 24)).astype(np.float32)
    k = rng.normal(size=(2, 70, 2, 24)).astype(np.float32)
    v = rng.normal(size=(2, 70, 2, 40)).astype(np.float32)
    for causal, window in ((True, 0), (False, 0), (True, 9), (False, 13)):
        want = j_flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), causal=causal,
                                     window=window, scale=0.3)
        got = flash_attention(to_tensor(q), to_tensor(k), to_tensor(v),
                              causal=causal, window=window, scale=0.3)
        np.testing.assert_allclose(as_np(got), as_np(want), rtol=1e-5,
                                   atol=1e-5)


def _args(B=1, S=16, H=4, KH=2, D=8, DV=8, dtype=torch.float32):
    return [torch.zeros((B, S, H, D), dtype=dtype),
            torch.zeros((B, S, KH, D), dtype=dtype),
            torch.zeros((B, S, KH, DV), dtype=dtype)]


def _bad(kind):
    a, window = _args(), 0
    if kind == "q-3d":
        a[0] = a[0][0]
    elif kind == "k-head-dim":
        a[1] = torch.zeros((1, 16, 2, 4))
    elif kind == "v-length":
        a[2] = torch.zeros((1, 15, 2, 8))
    elif kind == "heads-not-multiple":
        a = _args(H=3, KH=2)
    elif kind == "types-differ":
        a[1] = a[1].bfloat16()
    elif kind == "f16":
        a = _args(dtype=torch.float16)
    elif kind == "int":
        a = _args(dtype=torch.int32)
    elif kind == "head-dim-257":
        a = _args(D=257)
    elif kind == "value-dim-257":
        a = _args(DV=257)
    elif kind == "empty-sequence":
        a = _args(S=0)
    elif kind == "negative-window":
        window = -1
    return a, window


BAD = ["q-3d", "k-head-dim", "v-length", "heads-not-multiple", "types-differ",
       "f16", "int", "head-dim-257", "value-dim-257", "empty-sequence",
       "negative-window"]


@pytest.mark.parametrize("kind", BAD)
def test_check_args_refuses_what_the_kernel_does_not_take(kind):
    a, window = _bad(kind)
    with pytest.raises((ValueError, TypeError)):
        check_args(*a, window)
    with pytest.raises((ValueError, TypeError)):
        flash_attention(*a, window=window)


def test_check_args_accepts_the_repo_shapes():
    """Full-width TinyLlama (H 32 / KH 4 x 64), its OBSPA-pruned form (H 16
    / KH 2, D 64, DV 32), the reduced model and the widest head."""
    for H, KH, D, DV in [(32, 4, 64, 64), (16, 2, 64, 32), (4, 1, 16, 16),
                         (2, 1, 256, 256), (6, 2, 48, 40)]:
        for dt in (torch.float32, torch.bfloat16):
            check_args(*_args(H=H, KH=KH, D=D, DV=DV, dtype=dt))


def test_kernel_wrapper_refuses_cpu_tensors():
    """The kernel wrapper never falls back: a CPU tensor is refused (the
    dispatch in ops.py is what sends CPU tensors to the plain version)."""
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_attention_kernel(*_args())


class _FakeCuda(torch.Tensor):
    """A CPU tensor that says it is on CUDA, to reach the wrapper's checks
    past its device test on a machine without a card."""

    @property
    def is_cuda(self):
        return True


def test_kernel_refuses_autograd():
    """Forward only, as in the reference: with grad enabled and an input
    that requires grad, the wrapper raises before it builds or launches
    anything, and never hands the call to the plain version."""
    q, k, v = _args()
    q = q.as_subclass(_FakeCuda).requires_grad_(True)
    with pytest.raises(RuntimeError, match="forward only"):
        flash_attention_kernel(q, k, v)
    with pytest.raises(RuntimeError, match="forward only"):
        flash_attention(q, k, v)


# phase 10's bf16 shapes of the tensor-core instance, at CPU size for the
# emulation below: (B, S, H, KH, D, DV, causal, window)
TC_SHAPES = {
    "S128-D64": (1, 128, 2, 2, 64, 64, True, 0),
    "S96-D16-window32": (1, 96, 4, 4, 16, 16, True, 32),
    "S512-H8-KH1-D64-main": (1, 512, 8, 1, 64, 64, True, 0),
    "S512-D64-DV32-pruned": (1, 512, 8, 1, 64, 32, True, 0),
    "S333-D64": (1, 333, 8, 1, 64, 64, True, 0),
    "S512-D64-window100": (1, 512, 8, 1, 64, 64, True, 100),
    "S300-D64-bidir": (1, 300, 8, 1, 64, 64, False, 0),
    "S512-D128": (1, 512, 4, 1, 128, 128, True, 0),
    "S130-D256-DV200": (1, 130, 2, 1, 256, 200, True, 0),
    "S200-D48-DV20": (1, 200, 4, 2, 48, 20, True, 0),
    "S100-D20-bidir": (1, 100, 4, 1, 20, 20, False, 0),
    "S2048-D64": (1, 2048, 2, 1, 64, 64, True, 0),
    "S1024-D64-window256": (1, 1024, 4, 1, 64, 64, True, 256),
}
ONE_BF16_STEP = (2e-4, 2.0 ** -7)     # chip_smoke.py's bf16 tolerance


def tile_emulation(q, k, v, *, causal, window, split_p=True):
    """The tensor-core kernel's arithmetic in plain PyTorch, model layout,
    bf16 in and out: per 64-key tile, S = Q Kᵀ in f32, logits times
    scale·log2 e, masked ones -inf, running max from -1e30, p = exp2(s - m),
    P rounded to bf16 (``split_p``: plus the bf16 rounding of the rest, the
    second term the kernel multiplies) before an f32 PV, out = O / max(l,
    1e-30) rounded to bf16.  Tiles the kernel skips (wholly masked) leave
    the state as it is, so every tile is visited here."""
    B, Sq, H, D = q.shape
    Sk, KH, DV = k.shape[1], k.shape[2], v.shape[3]
    G = H // KH
    qf = q.float().transpose(1, 2)
    kf = k.float().transpose(1, 2).repeat_interleave(G, 1)
    vf = v.float().transpose(1, 2).repeat_interleave(G, 1)
    sl2 = torch.tensor(D ** -0.5, dtype=torch.float32) * torch.tensor(
        math.log2(math.e), dtype=torch.float32)
    m = torch.full((B, H, Sq), -1e30)
    l = torch.zeros((B, H, Sq))
    o = torch.zeros((B, H, Sq, DV))
    qi = torch.arange(Sq)[:, None]
    for k0 in range(0, Sk, 64):
        kt, vt = kf[:, :, k0:k0 + 64], vf[:, :, k0:k0 + 64]
        kj = torch.arange(k0, k0 + kt.shape[2])[None, :]
        live = torch.ones((Sq, kt.shape[2]), dtype=torch.bool)
        if causal:
            live &= kj <= qi
        if window:
            live &= kj > qi - window
        s = torch.where(live, (qf @ kt.transpose(-1, -2)) * sl2,
                        torch.tensor(-math.inf))
        mn = torch.maximum(m, s.amax(-1))
        alpha = torch.exp2(m - mn)
        p = torch.exp2(s - mn[..., None])
        l = l * alpha + p.sum(-1)
        hi = p.bfloat16().float()
        pv = hi @ vt
        if split_p:
            pv = pv + (p - hi).bfloat16().float() @ vt
        o = o * alpha[..., None] + pv
        m = mn
    out = o / torch.clamp(l, min=1e-30)[..., None]
    return out.transpose(1, 2).bfloat16()


def excess_over_one_bf16_step(got, ref) -> float:
    atol, rtol = ONE_BF16_STEP
    err = (got.float() - ref.float()).abs()
    return float((err - (atol + rtol * ref.float().abs())).max())


@pytest.mark.parametrize("case", sorted(TC_SHAPES))
def test_tensor_core_design_within_one_bf16_step(case):
    """The bf16 design, emulated, against the plain version (P in f32)
    within phase 10's tolerance ``2e-4 + 2^-7·|plain|`` at every bf16
    shape, and finite."""
    B, S, H, KH, D, DV, causal, window = TC_SHAPES[case]
    q, k, v = [to_tensor(a) for a in
               make_case(11, B, S, H, KH, D, DV, "bf16")]
    ref = flash_attention_ref(q, k, v, causal=causal, window=window)
    got = tile_emulation(q, k, v, causal=causal, window=window)
    assert got.shape == ref.shape and torch.isfinite(got.float()).all()
    assert excess_over_one_bf16_step(got, ref) <= 0, case


def test_one_bf16_rounding_of_p_would_not_fit():
    """Why P is split in two: rounded once to bf16 before PV (as the
    model's plain attention does), p moves outputs near zero by more than
    the tolerance's 2e-4 at the main path's shape; the two-term split does
    not."""
    B, S, H, KH, D, DV, causal, window = TC_SHAPES["S512-H8-KH1-D64-main"]
    q, k, v = [to_tensor(a) for a in
               make_case(11, B, S, H, KH, D, DV, "bf16")]
    ref = flash_attention_ref(q, k, v, causal=causal, window=window)
    once = tile_emulation(q, k, v, causal=causal, window=window,
                          split_p=False)
    assert excess_over_one_bf16_step(once, ref) > 0
    assert excess_over_one_bf16_step(
        tile_emulation(q, k, v, causal=causal, window=window), ref) <= 0


def test_plan_puts_every_bf16_shape_on_tensor_cores():
    """Every bf16 head-dim pair ``check_args`` accepts maps to a tensor-core
    instance whose accumulator holds DV (the narrowest such); every f32
    shape maps to the CUDA-core instance."""
    for D in (1, 8, 16, 20, 48, 64, 100, 128, 200, 256):
        for DV in range(1, 257):
            a = _args(S=2, H=2, KH=1, D=D, DV=DV, dtype=torch.bfloat16)
            check_args(*a)
            pl = plan(*a)
            assert pl.instance == "wgmma" and DV <= pl.dv_tile, (D, DV)
            assert pl.dv_tile == min(t for t in DV_TILES if DV <= t)
            f = _args(S=2, H=2, KH=1, D=D, DV=DV)
            assert plan(*f) == ("cuda_core", 0, False, 1)


def test_plan_packs_query_heads_of_one_kv_head():
    """Two query heads of one KV head share a block (and its K/V tiles)
    where the group size H / KH is even; one otherwise."""
    for H, KH, heads in ((32, 4, 2), (16, 2, 2), (4, 2, 2), (6, 2, 1),
                         (4, 4, 1), (3, 1, 1)):
        a = _args(S=2, H=H, KH=KH, dtype=torch.bfloat16)
        assert plan(*a).heads == heads, (H, KH)


def test_plan_copy_path_follows_row_alignment():
    """16-byte ``cp.async`` where every q / k / v row starts on 16 bytes
    (the model's tensors, D 48), the narrow copy path for a view offset by
    one element or 40-byte rows (D 20)."""
    a = _args(B=2, S=8, H=4, KH=2, D=64, DV=64, dtype=torch.bfloat16)
    assert plan(*a) == ("wgmma", 64, True, 2)
    assert plan(*_args(B=2, S=8, H=4, KH=2, D=48, DV=32,
                       dtype=torch.bfloat16)).vec16
    assert not plan(*_args(B=2, S=8, H=4, KH=2, D=20, DV=20,
                           dtype=torch.bfloat16)).vec16
    buf = torch.zeros(a[0].numel() + 1, dtype=torch.bfloat16)
    q1 = buf[1:].view(a[0].shape)
    assert not plan(q1, a[1], a[2]).vec16
    # the model layout (B, S, H, D) read as (B, H, S, D) strides: still rows
    # of 128 bytes on the grid
    assert plan(a[0].transpose(1, 2).contiguous().transpose(1, 2), a[1],
                a[2]).vec16


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no interpret mode "
                    "(python3 chip_smoke.py makes this comparison on the "
                    "card)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_cuda_kernel_vs_plain_on_the_card(cuda_device):
    """The reference's shapes at its tolerance, then the tensor-core
    shapes (also as views one element into their storage, the narrow copy
    path) within one bf16 step."""
    from repro_torch.kernels.flash_attention import launch_count
    cases = [(SHAPES[c], 0) + (TOL[SHAPES[c][-1]],) * 2
             for c in sorted(SHAPES)]
    cases += [(TC_SHAPES[c] + ("bf16",), off) + ONE_BF16_STEP
              for c in sorted(TC_SHAPES) for off in (0, 1)]
    for shape, offset, atol, rtol in cases:
        B, S, H, KH, D, DV, causal, window, dt = shape
        t = []
        for a in make_case(5, B, S, H, KH, D, DV, dt):
            x = to_tensor(a, cuda_device)
            buf = torch.zeros(x.numel() + offset, dtype=x.dtype,
                              device=cuda_device)
            t.append(buf[offset:].view(x.shape).copy_(x))
        assert plan(*t).instance == ("wgmma" if dt == "bf16"
                                     else "cuda_core")
        before = launch_count()
        out = flash_attention(*t, causal=causal, window=window)
        torch.cuda.synchronize()
        assert launch_count() == before + 1
        ref = flash_attention_ref(*t, causal=causal, window=window)
        err = (out.float() - ref.float()).abs()
        assert float((err - (atol + rtol * ref.float().abs())).max()) <= 0, \
            (shape, offset)
