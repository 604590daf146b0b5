"""The Hopper design of the SSD chunked-scan kernel K3, emulated on the CPU.

The CUDA kernel has no interpret mode, so its arithmetic is modelled here in
plain PyTorch and held to the reference's tolerances (``tests/
test_kernels.py::test_ssd_scan``: max|Δ| / max|ref| below 1e-5 for f32 x and
3e-2 for bf16 x, y in x's type), against the JAX package's
``ssd_reference`` and against the plain scan in float64:

- TF32 rounding to nearest with ties away from zero, done on the int32 view
  as the kernel does it (the rounding of ``cvt.rna.tf32.f32``);
- each f32 operand split as hi = tf32(a), lo = tf32(a - hi), and each
  product taken in the kernel's passes with f32 sums: C Bᵀ exact for bf16
  B/C (three passes for f32); M = (C Bᵀ) ⊙ L times x in three passes (two
  for bf16 x); C stateᵀ and the state update, with the decay on x, in two
  passes (three for f32 B/C);
- sub-chunks of ``sub_chunk(Q)`` rows (64 for Mamba-2's 128), the
  cumulative sum in double within each, the state carried in f32;
- M above the diagonal selected as 0, never multiplied with exp.

It also records why the split is needed: one TF32 pass a product misses
1e-5 at Mamba-2's widths.  ``check_args`` and the shared-memory mirror
``smem_bytes`` are held to every shape the repo runs.  The card runs the kernel itself against the plain
version (``tests/test_torch_ssd_scan.py::test_cuda_kernel_vs_plain_on_the_
card``, marked ``gpu``, and ``chip_smoke.py`` phase 8).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.models.ssm import ssd_reference as j_ssd_reference
from repro_torch.convert import to_tensor
from repro_torch.kernels.ssd_scan import check_args, ssd_scan_ref
from repro_torch.kernels.ssd_scan.ssd_scan import (
    MAX_SMEM, smem_bytes, sub_chunk)
from repro_torch.models.ssm import ssd_reference
from test_torch_ssd_scan import SHAPES, make_case, rel, tol


@pytest.fixture(autouse=True)
def _one_thread():
    """Many small products: one intra-op thread keeps them from contending
    for the cores with the other test workers (restored after each test)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tf32(a: torch.Tensor) -> torch.Tensor:
    """f32 rounded to TF32 (10 fraction bits), to nearest, ties away from
    zero: add half of the 13 dropped bits to the magnitude, clear them."""
    u = a.float().contiguous().view(torch.int32)
    return ((u + 0x1000) & ~0x1FFF).view(torch.float32)


def split(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    hi = tf32(a)
    return hi, tf32(a.float() - hi)


def product(a, b, exact_a: bool, exact_b: bool, one_pass: bool = False):
    """a @ b as the kernel takes it on the TF32 tensor cores: an exact
    operand (bf16-valued) is not split; the passes lo·hi, hi·lo, hi·hi are
    summed in f32.  ``one_pass``: a single TF32 product, for contrast."""
    if one_pass:
        return tf32(a) @ tf32(b)
    ah, al = (a, None) if exact_a else split(a)
    bh, bl = (b, None) if exact_b else split(b)
    out = ah @ bh
    if al is not None:
        out = out + al @ bh
    if bl is not None:
        out = out + ah @ bl
    return out


def emulate(x, dt, A, B, C, chunk: int, one_pass: bool = False):
    """y (b, l, h, p) f32 by the kernel's arithmetic, every (batch, head)
    stream at once."""
    b, l, h, p = x.shape
    q = sub_chunk(chunk)
    xb, bb = x.dtype == torch.bfloat16, B.dtype == torch.bfloat16
    xs = x.float().permute(0, 2, 1, 3)                     # (b, h, l, p)
    Bs, Cs = B.float()[:, None], C.float()[:, None]        # (b, 1, l, n)
    dA = (dt * A).permute(0, 2, 1)                         # (b, h, l) f32
    S = torch.zeros(b, h, p, B.shape[-1])
    tri = torch.tril(torch.ones(q, q, dtype=torch.bool))
    ys = []
    for c0 in range(0, l, q):
        sl = slice(c0, c0 + q)
        cs = torch.cumsum(dA[..., sl].double(), -1)        # (b, h, q)
        ecs = torch.exp(cs.float())
        dec = torch.exp((cs[..., -1:] - cs).float())
        Cc, Bc, xc = Cs[:, :, sl], Bs[:, :, sl], xs[:, :, sl]
        G = product(Cc, Bc.transpose(-1, -2), bb, bb, one_pass)
        L = torch.exp((cs[..., :, None] - cs[..., None, :]).float())
        M = torch.where(tri, G * torch.where(tri, L, 0.0), 0.0)
        y_diag = product(M, xc, False, xb, one_pass)
        y_off = product(Cc, S.transpose(-1, -2), bb, False, one_pass)
        ys.append(ecs[..., None] * y_off + y_diag)
        Xd = dec[..., None] * xc                           # (b, h, q, p)
        S = torch.exp(cs[..., -1].float())[..., None, None] * S + product(
            Xd.transpose(-1, -2), Bc, False, bb, one_pass)
    return torch.cat(ys, 2).permute(0, 2, 1, 3)


def float64_scan(arrs, chunk):
    return ssd_reference(*[to_tensor(a).double() for a in arrs], chunk)[0]


def held(arrs, chunk, xd):
    """The emulation against the JAX reference and float64, as x's type."""
    t = [to_tensor(a) for a in arrs]
    y = emulate(*t, chunk).to(t[0].dtype)
    jy, _ = j_ssd_reference(*[jnp.asarray(a) for a in arrs], chunk)
    return rel(y.float().numpy(), jy), rel(
        y.float().numpy(), float64_scan(arrs, chunk).numpy())


@pytest.mark.parametrize("case", sorted(SHAPES))
def test_emulation_vs_jax_and_float64(case):
    b, l, h, p, n, Q, xd, bd = SHAPES[case]
    e_jax, e_64 = held(make_case(1, b, l, h, p, n, xd, bd), Q, xd)
    assert e_jax < tol(xd) and e_64 < tol(xd), (e_jax, e_64)


def test_emulation_large_dt_stays_finite_and_accurate():
    """dt·|A|·Q up to 8192: exp above the diagonal overflows to inf, and
    the selection keeps it out of M."""
    b, l, h, p, n, Q = 1, 256, 4, 16, 32, 128
    xdt, dt, A, B, C = make_case(4, b, l, h, p, n, "f32", "bf16",
                                 dt_lo=1.0, dt_span=3.0)
    A = -np.linspace(1.0, 16.0, h).astype(np.float32)
    arrs = (xdt, dt, A, B, C)
    y = emulate(*[to_tensor(a) for a in arrs], Q)
    assert torch.isfinite(y).all()
    e_jax, e_64 = held(arrs, Q, "f32")
    assert e_jax < 1e-5 and e_64 < 1e-5, (e_jax, e_64)


@pytest.mark.parametrize("p,n", [(40, 48), (11, 13)])
def test_emulation_odd_pruned_width(p, n):
    """Widths another pruning ratio leaves (the kernel pads them to 16 with
    zeros, which add nothing)."""
    arrs = make_case(6, 1, 256, 3, p, n, "f32", "bf16")
    e_jax, e_64 = held(arrs, 128, "f32")
    assert e_jax < 1e-5 and e_64 < 1e-5, (e_jax, e_64)


def test_one_tf32_pass_misses_the_tolerance_the_split_meets():
    """At Mamba-2's widths (Q 128, p 64, n 128; x f32, B/C bf16) one TF32
    pass a product keeps about 2^-11 of each operand and misses 1e-5; the
    split passes meet it."""
    arrs = make_case(7, 1, 256, 2, 64, 128, "f32", "bf16")
    t = [to_tensor(a) for a in arrs]
    gold = float64_scan(arrs, 128).numpy()
    e_split = rel(emulate(*t, 128).numpy(), gold)
    e_one = rel(emulate(*t, 128, one_pass=True).numpy(), gold)
    assert e_split < 1e-5 < e_one, (e_split, e_one)
    assert e_one > 10 * e_split


def test_tf32_rounding_is_to_nearest_ties_away():
    """The kernel's two integer operations round as cvt.rna does: 13 low
    bits cleared, a tie goes away from zero, hi + lo within 2^-22 of a."""
    one = torch.tensor([1.0]).view(torch.int32)
    half_ulp = (one + 0x1000).view(torch.float32)   # exactly between two
    below = (one + 0x0FFF).view(torch.float32)
    assert tf32(half_ulp).item() == 1.0 + 2.0 ** -10
    assert tf32(-half_ulp).item() == -(1.0 + 2.0 ** -10)
    assert tf32(below).item() == 1.0
    a = torch.from_numpy(np.random.default_rng(8).normal(
        size=4096).astype(np.float32))
    hi, lo = split(a)
    for v in (hi, lo):
        assert (v.view(torch.int32) & 0x1FFF == 0).all()
    assert ((hi + lo - a).abs() <= a.abs() * 2.0 ** -22).all()


def test_sub_chunks_give_the_chunks_result():
    """The scan does not depend on where chunks fall: Q 128 taken as two
    sub-chunks of 64 (the kernel's) matches the plain scan at 128."""
    arrs = make_case(9, 2, 256, 3, 32, 64, "f32", "f32")
    t = [to_tensor(a) for a in arrs]
    assert sub_chunk(128) == 64
    assert rel(emulate(*t, 128).numpy(),
               ssd_scan_ref(*t, 128).numpy()) < 1e-5


# (p, n, Q): Mamba-2 1.3B and its 50 % prune, hymba's SSM heads, the
# reduced configs, the reference's grid, widths other ratios leave (37.5 %
# of Mamba-2 1.3B: p 40, n 80), a wide head
REPO_SHAPES = [(64, 128, 128), (32, 64, 128), (64, 16, 128), (16, 16, 16),
               (8, 8, 16), (32, 64, 64), (64, 128, 32), (16, 32, 32),
               (40, 48, 128), (40, 80, 128), (11, 13, 64), (128, 64, 128)]
TYPES = [(torch.float32, torch.float32), (torch.float32, torch.bfloat16),
         (torch.bfloat16, torch.bfloat16)]


@pytest.mark.parametrize("types", TYPES, ids=["f32", "x-f32-bc-bf16",
                                             "bf16"])
@pytest.mark.parametrize("p,n,Q", REPO_SHAPES)
def test_plan_and_check_args_take_every_repo_shape(p, n, Q, types):
    """Every shape the repo runs is accepted, and a block's tiles fit."""
    xdt, bdt = types
    assert smem_bytes(Q, p, n, xdt == torch.bfloat16,
                      bdt == torch.bfloat16) <= MAX_SMEM
    assert Q % sub_chunk(Q) == 0
    args = [torch.zeros((1, 2 * Q, 2, p), dtype=xdt),
            torch.zeros((1, 2 * Q, 2)), -torch.ones((2,)),
            torch.zeros((1, 2 * Q, n), dtype=bdt),
            torch.zeros((1, 2 * Q, n), dtype=bdt)]
    check_args(*args, Q)


def test_plan_fits_two_blocks_an_sm_at_mamba2_width():
    """Full and pruned Mamba-2 (x f32, B/C bf16) in sub-chunks of 64 fit two
    blocks in an SM's 228 KB (each block also holds 1 KB for the system);
    the float32 model's f32 B/C fit one."""
    full = smem_bytes(128, 64, 128, False, True)
    pruned = smem_bytes(128, 32, 64, False, True)
    f32 = smem_bytes(128, 64, 128, False, False)
    assert (sub_chunk(128), full) == (64, 108800)
    assert 2 * (full + 1024) <= 233472 and pruned < full
    assert f32 <= MAX_SMEM


@pytest.mark.parametrize("Q,q", [(16, 16), (32, 32), (48, 48), (64, 64),
                                 (80, 16), (96, 48), (128, 64), (256, 64)])
def test_sub_chunk(Q, q):
    assert sub_chunk(Q) == q
