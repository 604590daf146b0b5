"""PyTorch port vs JAX reference: the Mamba-2 SSD chunked scan (kernel K3).

The same numpy inputs (seeded) go through the port's plain version
(``ssd_reference``, and ``ops.ssd_scan`` whose CPU route it is) and through
the JAX package's ``ssd_reference`` and its Pallas ``ssd_scan`` in interpret
mode.  The tolerance is the reference's (``tests/test_kernels.py``):
max|Δ| / max|ref| below 1e-5 for f32 and 3e-2 for bf16 inputs.  The CUDA
kernel itself has no interpret mode: its comparison with the plain version
is the ``gpu``-marked test below, and ``chip_smoke.py`` phase 8 on the card.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.ssd_scan import ssd_scan as j_ssd_scan
from repro.models.ssm import ssd_reference as j_ssd_reference
from repro_torch.convert import to_tensor
from repro_torch.kernels.ssd_scan import (
    check_args, ssd_scan, ssd_scan_kernel, ssd_scan_ref)
from repro_torch.kernels.ssd_scan.ssd_scan import (
    MAX_SMEM, smem_bytes, sub_chunk)
from repro_torch.models.ssm import ssd_reference

# the reference's grid (tests/test_kernels.py::test_ssd_scan), then the
# model's own call: x f32 (dt applied in f32), B/C in the bf16 model dtype
SHAPES = {
    "b2-l64-h4-p16-n16-Q16-f32": (2, 64, 4, 16, 16, 16, "f32", "f32"),
    "b1-l256-h2-p32-n64-Q64-f32": (1, 256, 2, 32, 64, 64, "f32", "f32"),
    "b2-l128-h8-p64-n128-Q32-f32": (2, 128, 8, 64, 128, 32, "f32", "f32"),
    "b1-l64-h2-p16-n32-Q32-bf16": (1, 64, 2, 16, 32, 32, "bf16", "bf16"),
    "model-call-x-f32-bc-bf16": (1, 64, 4, 32, 64, 32, "f32", "bf16"),
}
NP = {"f32": np.float32, "bf16": jnp.bfloat16}


def make_case(seed, b, l, h, p, n, xd, bd, dt_lo=0.05, dt_span=0.5,
              a_lo=0.1):
    """numpy inputs as the reference's test draws them: x·dt rounded to x's
    type, dt f32, A negative, B/C in their type."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, l, h, p)).astype(np.float32)
    dt = (rng.random((b, l, h)) * dt_span + dt_lo).astype(np.float32)
    A = (-np.abs(rng.normal(size=(h,))) - a_lo).astype(np.float32)
    B = rng.normal(size=(b, l, n)).astype(np.float32)
    C = rng.normal(size=(b, l, n)).astype(np.float32)
    xdt = np.asarray(jnp.asarray(x * dt[..., None]).astype(NP[xd]))
    B = np.asarray(jnp.asarray(B).astype(NP[bd]))
    C = np.asarray(jnp.asarray(C).astype(NP[bd]))
    return xdt, dt, A, B, C


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-9))


def tol(xd) -> float:
    """By the type of y (x's): both sides compute in f32 from the same
    inputs; a bf16 y adds one bf16 rounding."""
    return 3e-2 if xd == "bf16" else 1e-5


def as_np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


@pytest.mark.parametrize("case", sorted(SHAPES))
def test_plain_vs_jax_reference_and_interpret_kernel(case):
    b, l, h, p, n, Q, xd, bd = SHAPES[case]
    arrs = make_case(1, b, l, h, p, n, xd, bd)
    j = [jnp.asarray(a) for a in arrs]
    t = [to_tensor(a) for a in arrs]
    jy, jfin = j_ssd_reference(*j, Q)
    jk = j_ssd_scan(*j, Q)                      # Pallas, interpret mode
    ty, tfin = ssd_reference(*t, Q)
    assert ty.dtype == torch.float32 and tfin.shape == (b, h, p, n)
    assert rel(as_np(ty), jy) < 1e-5
    assert rel(as_np(tfin), jfin) < 1e-5
    assert rel(as_np(ssd_scan_ref(*t, Q)), jy) < 1e-5
    # the dispatch's CPU route: the plain version, in x's dtype
    y = ssd_scan(*t, Q)
    assert y.dtype == t[0].dtype and y.shape == (b, l, h, p)
    assert rel(as_np(y), jk) < tol(xd)


@pytest.mark.parametrize("chunk", [16, 64])
def test_init_state_and_final_state_vs_jax(chunk):
    """ssm_prefill's use: a carried state in, the final state out."""
    b, l, h, p, n = 2, 64, 3, 16, 32
    arrs = make_case(2, b, l, h, p, n, "f32", "f32")
    s0 = np.random.default_rng(3).normal(size=(b, h, p, n)).astype(
        np.float32)
    jy, jfin = j_ssd_reference(*[jnp.asarray(a) for a in arrs], chunk,
                               init_state=jnp.asarray(s0))
    ty, tfin = ssd_reference(*[to_tensor(a) for a in arrs], chunk,
                             init_state=to_tensor(s0))
    assert rel(as_np(ty), jy) < 1e-5
    assert rel(as_np(tfin), jfin) < 1e-5
    # the state is the state: scanning the two halves in turn, the second
    # from the first's final state, gives the same y and final state
    cut = [lambda a, s=s: a if a.ndim == 1 else a[:, s]
           for s in (slice(0, l // 2), slice(l // 2, l))]
    half = [to_tensor(cut[0](a)) for a in arrs]
    rest = [to_tensor(cut[1](a)) for a in arrs]
    q = min(chunk, l // 2)
    y1, f1 = ssd_reference(*half, q, init_state=to_tensor(s0))
    y2, f2 = ssd_reference(*rest, q, init_state=f1)
    assert rel(as_np(torch.cat([y1, y2], 1)), jy) < 1e-5
    assert rel(as_np(f2), jfin) < 1e-5


def test_large_dt_upper_triangle_stays_finite():
    """dt·|A|·Q far above 88: exp(cs_i - cs_j) above the diagonal would
    overflow; both versions select it away, so y is finite and the port
    agrees with the reference."""
    b, l, h, p, n, Q = 1, 256, 4, 16, 32, 128
    xdt, dt, A, B, C = make_case(4, b, l, h, p, n, "f32", "f32",
                                 dt_lo=1.0, dt_span=3.0)
    A = -np.linspace(1.0, 16.0, h).astype(np.float32)
    assert float(dt.max() * -A.min() * Q) > 88 * 10
    ty = ssd_scan(*[to_tensor(a) for a in (xdt, dt, A, B, C)], Q)
    jy, _ = j_ssd_reference(*[jnp.asarray(a) for a in (xdt, dt, A, B, C)], Q)
    assert torch.isfinite(ty).all()
    assert np.isfinite(np.asarray(jy)).all()
    assert rel(as_np(ty), jy) < 1e-5


def _args(b=1, l=32, h=2, p=8, n=16, xdt=torch.float32, bdt=torch.float32):
    return [torch.zeros((b, l, h, p), dtype=xdt),
            torch.zeros((b, l, h)), -torch.ones((h,)),
            torch.zeros((b, l, n), dtype=bdt),
            torch.zeros((b, l, n), dtype=bdt)]


def _bad(kind):
    a = _args()
    chunk = 16
    if kind == "x-3d":
        a[0] = a[0][0]
    elif kind == "dt-shape":
        a[1] = a[1][:, :-1]
    elif kind == "A-shape":
        a[2] = a[2][:1]
    elif kind == "C-shape":
        a[4] = torch.zeros((1, 32, 8))
    elif kind == "x-int":
        a[0] = a[0].to(torch.int32)
    elif kind == "x-f16":
        a[0] = a[0].half()
    elif kind == "dt-bf16":
        a[1] = a[1].bfloat16()
    elif kind == "A-f64":
        a[2] = a[2].double()
    elif kind == "B-C-types-differ":
        a[3] = a[3].bfloat16()
    elif kind == "B-not-contiguous":
        a[3] = torch.zeros((1, 32, 32))[:, :, ::2]
    elif kind == "l-not-multiple":
        chunk = 12
    elif kind == "chunk-not-multiple-of-4":
        a = _args(l=30)
        chunk = 6
    elif kind == "chunk-not-multiple-of-16":
        chunk = 8
    elif kind == "tiles-too-big":
        a = _args(p=256, n=256, l=128)
        chunk = 128
    return a, chunk


BAD = ["x-3d", "dt-shape", "A-shape", "C-shape", "x-int", "x-f16", "dt-bf16",
       "A-f64", "B-C-types-differ", "B-not-contiguous", "l-not-multiple",
       "chunk-not-multiple-of-4", "chunk-not-multiple-of-16", "tiles-too-big"]


@pytest.mark.parametrize("kind", BAD)
def test_check_args_refuses_what_the_kernel_does_not_take(kind):
    a, chunk = _bad(kind)
    with pytest.raises((ValueError, TypeError)):
        check_args(*a, chunk)
    if kind != "B-not-contiguous":      # the dispatch makes inputs contiguous
        with pytest.raises((ValueError, TypeError)):
            ssd_scan(*a, chunk)


def test_check_args_accepts_the_repo_shapes():
    """Every (p, n, Q) the repo produces fits the kernel's shared memory:
    the reference grid, the reduced model (16, 16, 16) and its 50 %-pruned
    (8, 8, 16), full-width mamba2-1.3b (64, 128, 128) and its 50 %-pruned
    (32, 64, 128), and odd widths another ratio leaves (the kernel pads p
    and n inside shared memory); full width runs in sub-chunks of 64 rows,
    two blocks an SM."""
    for p, n, Q in [(16, 16, 16), (32, 64, 64), (64, 128, 32), (16, 32, 32),
                    (8, 8, 16), (64, 128, 128), (32, 64, 128),
                    (11, 13, 16)]:           # a pruning ratio's odd widths
        for xdt, bdt in [(torch.float32, torch.float32),
                         (torch.float32, torch.bfloat16),
                         (torch.bfloat16, torch.bfloat16)]:
            assert smem_bytes(Q, p, n, xdt == torch.bfloat16,
                              bdt == torch.bfloat16) <= MAX_SMEM
            check_args(*_args(l=2 * Q, p=p, n=n, xdt=xdt, bdt=bdt), Q)
    assert sub_chunk(128) == 64
    assert smem_bytes(128, 64, 128, False, True) == 108800


def test_kernel_wrapper_refuses_cpu_tensors():
    """The kernel wrapper never falls back: a CPU tensor is refused (the
    dispatch in ops.py is what sends CPU tensors to the plain version)."""
    with pytest.raises(ValueError, match="CUDA tensors"):
        ssd_scan_kernel(*_args(), 16)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no interpret mode "
                    "(python3 chip_smoke.py makes this comparison on the "
                    "card)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_cuda_kernel_vs_plain_on_the_card(cuda_device):
    """Each call launches the kernel once, agrees with the plain version,
    and gives the same bits when repeated (no atomics)."""
    from repro_torch.kernels.ssd_scan import launch_count
    for case in sorted(SHAPES):
        b, l, h, p, n, Q, xd, bd = SHAPES[case]
        t = [to_tensor(a, cuda_device)
             for a in make_case(5, b, l, h, p, n, xd, bd)]
        before = launch_count()
        y = ssd_scan(*t, Q)
        torch.cuda.synchronize()
        assert launch_count() == before + 1
        again = ssd_scan(*t, Q)
        torch.cuda.synchronize()
        assert launch_count() == before + 2
        assert torch.equal(y, again), case
        ref = ssd_scan_ref(*t, Q)
        assert rel(as_np(y.cpu()), as_np(ref.cpu())) < tol(xd), case
