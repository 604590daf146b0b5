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
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.flash_attention import (
    flash_attention as j_flash_attention,
    flash_attention_ref as j_flash_attention_ref)
from repro_torch.convert import to_tensor
from repro_torch.kernels.flash_attention import (
    check_args, flash_attention, flash_attention_kernel, flash_attention_ref)
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


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no interpret mode "
                    "(python3 chip_smoke.py makes this comparison on the "
                    "card)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_cuda_kernel_vs_plain_on_the_card(cuda_device):
    from repro_torch.kernels.flash_attention import launch_count
    for case in sorted(SHAPES):
        B, S, H, KH, D, DV, causal, window, dt = SHAPES[case]
        t = [to_tensor(a, cuda_device)
             for a in make_case(5, B, S, H, KH, D, DV, dt)]
        before = launch_count()
        out = flash_attention(*t, causal=causal, window=window)
        torch.cuda.synchronize()
        assert launch_count() == before + 1
        ref = flash_attention_ref(*t, causal=causal, window=window)
        np.testing.assert_allclose(as_np(out.cpu()), as_np(ref.cpu()),
                                   rtol=TOL[dt], atol=TOL[dt], err_msg=case)
