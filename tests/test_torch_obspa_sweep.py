"""PyTorch port vs JAX reference: the OBSPA reconstruction sweep (K4).

The port's blocked sweep (``repro_torch.kernels.obspa_update``) runs its
plain in-block version on CPU tensors; it is held against the float64 oracle
``sweep_oracle`` and against the JAX ``obspa_sweep`` (Pallas kernel in
interpret mode) on the same numpy inputs: the reference's four shapes, the
zeroes-pruned-columns case and a batched case.  Tolerance: error relative to
``|oracle|.max()`` under 1e-4, as ``tests/test_kernels.py`` holds the JAX
sweep.  The CUDA kernel itself has no interpret mode: its test is marked
``gpu`` and skips here (``python3 chip_smoke.py`` makes the same comparison
on the card at the main path's shapes).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.obspa_update import obspa_sweep as j_sweep
from repro.kernels.obspa_update import sweep_oracle as j_oracle
from repro.kernels.obspa_update.obspa_update import (
    inblock_sweep as j_inblock)
from repro_torch.kernels.obspa_update import (
    BLOCK, inblock_sweep, inblock_sweep_kernel, inblock_sweep_plain,
    obspa_sweep, obspa_sweep_batched, sweep_numpy, sweep_oracle,
    sweep_plain)

torch.backends.cuda.matmul.allow_tf32 = False

RTOL = 1e-4


def make_case(seed, R, K, frac, nb=None):
    """W, Hinv (inverse of a damped sample covariance), mask — numpy f32."""
    rng = np.random.default_rng(seed)
    lead = () if nb is None else (nb,)
    W = rng.normal(size=lead + (R, K)).astype(np.float32)
    Hs = []
    for _ in range(nb or 1):
        X = rng.normal(size=(K, 4 * K)).astype(np.float32)
        H = (X @ X.T / (4 * K) + 0.01 * np.eye(K)).astype(np.float32)
        Hs.append(np.linalg.inv(H).astype(np.float32))
    Hinv = np.stack(Hs) if nb is not None else Hs[0]
    mask = rng.random(K) < frac
    return W, Hinv, mask


def rel(a, gold):
    return float(np.abs(np.asarray(a) - gold).max()
                 / (np.abs(gold).max() + 1e-9))


@pytest.mark.parametrize("R,K,frac", [
    (64, 96, 0.3), (100, 256, 0.5), (17, 130, 0.7), (256, 128, 0.25),
])
def test_sweep_vs_oracle_and_jax(R, K, frac):
    W, Hinv, mask = make_case(R * K, R, K, frac)
    gold = j_oracle(W, Hinv, mask)
    np.testing.assert_array_equal(sweep_oracle(W, Hinv, mask), gold)
    port = obspa_sweep(torch.from_numpy(W), torch.from_numpy(Hinv),
                       torch.from_numpy(mask))
    assert port.dtype == torch.float32 and port.shape == (R, K)
    jx = np.asarray(j_sweep(W, Hinv, mask))
    plain = sweep_plain(torch.from_numpy(W), torch.from_numpy(Hinv),
                        torch.from_numpy(mask))
    assert rel(port.numpy(), gold) < RTOL
    assert rel(jx, gold) < RTOL
    assert rel(plain.numpy(), gold) < RTOL
    assert rel(port.numpy(), jx) < RTOL


def test_sweep_zeroes_pruned_columns():
    rng = np.random.default_rng(3)
    R, K = 32, 64
    W = rng.normal(size=(R, K)).astype(np.float32)
    Hinv = np.eye(K, dtype=np.float32)
    mask = np.zeros(K, bool)
    mask[[3, 10, 50]] = True
    out = obspa_sweep(torch.from_numpy(W), torch.from_numpy(Hinv),
                      torch.from_numpy(mask)).numpy()
    assert np.abs(out[:, mask]).max() < 1e-6
    # identity Hessian -> no compensation of kept columns
    np.testing.assert_allclose(out[:, ~mask], W[:, ~mask], atol=1e-6)
    jx = np.asarray(j_sweep(W, Hinv, mask))
    np.testing.assert_allclose(out, jx, atol=1e-6)


def test_sweep_batched_vs_per_entry():
    """The batch axis (experts in the reference's Python loop) gives each
    entry its own Hinv and the shared mask."""
    W, Hinv, mask = make_case(11, 40, 200, 0.5, nb=3)
    out = obspa_sweep_batched(torch.from_numpy(W), torch.from_numpy(Hinv),
                              torch.from_numpy(mask)).numpy()
    for e in range(3):
        gold = sweep_numpy(W[e], Hinv[e], mask)
        assert rel(out[e], gold) < RTOL
        assert rel(out[e], np.asarray(j_sweep(W[e], Hinv[e], mask))) < RTOL


@pytest.mark.parametrize("frac", [0.0, 0.5, 1.0])
def test_inblock_plain_vs_jax_interpret_kernel(frac):
    """The plain in-block version returns what the Pallas kernel returns:
    the updated block and E, both f32."""
    W, Hinv, mask = make_case(5, 70, BLOCK, frac)
    jw, je = j_inblock(jnp.asarray(W), jnp.asarray(Hinv), jnp.asarray(mask),
                       row_block=32, interpret=True)
    tw, te = inblock_sweep(torch.from_numpy(W), torch.from_numpy(Hinv),
                           torch.from_numpy(mask))
    assert tw.shape == te.shape == (70, BLOCK)
    assert tw.dtype == te.dtype == torch.float32
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(te.numpy(), np.asarray(je), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_array_equal(te.numpy()[:, ~mask], 0.0)


def test_inblock_out_is_written_in_place():
    W, Hinv, mask = make_case(6, 9, BLOCK, 0.5)
    w = torch.from_numpy(W)
    buf = torch.zeros((9, 2 * BLOCK))
    view = buf[:, BLOCK:]
    new, e = inblock_sweep(w, torch.from_numpy(Hinv), torch.from_numpy(mask),
                           out=view)
    ref_w, ref_e = inblock_sweep_plain(w[None], torch.from_numpy(Hinv)[None],
                                       torch.from_numpy(mask))
    assert new.data_ptr() == view.data_ptr()
    torch.testing.assert_close(buf[:, BLOCK:], ref_w[0], rtol=0, atol=0)
    torch.testing.assert_close(e, ref_e[0], rtol=0, atol=0)
    assert float(buf[:, :BLOCK].abs().max()) == 0.0


def test_kernel_wrapper_refuses_cpu_tensors():
    """The kernel wrapper never falls back: a CPU tensor is refused (the
    dispatch in ops.py is what sends CPU tensors to the plain version)."""
    with pytest.raises(ValueError, match="CUDA tensors"):
        inblock_sweep_kernel(torch.zeros(4, BLOCK), torch.eye(BLOCK),
                             torch.zeros(BLOCK, dtype=torch.bool))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no interpret mode "
                    "(python3 chip_smoke.py makes this comparison on the "
                    "card)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_cuda_kernel_vs_plain_on_the_card(cuda_device):
    W, Hinv, mask = make_case(7, 300, 300, 0.5, nb=2)
    args = [torch.from_numpy(a).to(cuda_device) for a in (W, Hinv, mask)]
    out = obspa_sweep_batched(*args)
    plain = sweep_plain(args[0].double(), args[1].double(), args[2])
    err = float((out.double() - plain).abs().max() / plain.abs().max())
    assert err < RTOL
    w, e = inblock_sweep_kernel(args[0][:, :, :BLOCK], args[1][:, :BLOCK,
                                                                :BLOCK],
                                args[2][:BLOCK])
    pw, pe = inblock_sweep_plain(args[0][:, :, :BLOCK],
                                 args[1][:, :BLOCK, :BLOCK], args[2][:BLOCK])
    assert float((w - pw).abs().max()) < 1e-4
    assert float((e - pe).abs().max()) < 1e-4


def edge_case(name):
    """The design's edge cases of one block (W (nb, R, 128), Hinv (1 or nb,
    128, 128), mask), numpy, as ``test_torch_obspa_sweep_design`` models
    them."""
    if name.startswith("R "):
        R = int(name[2:])
        W, Hinv, mask = make_case(R, R, BLOCK, 0.5)
        return W[None], Hinv[None], mask
    if name == "nb 4 shared Hinv":
        W, _, mask = make_case(8, 24, BLOCK, 0.5, nb=4)
        return W, make_case(9, 4, BLOCK, 0.5)[1][None], mask
    W, Hinv, _ = make_case(5, 70, BLOCK, 0.0)
    mask = np.zeros(BLOCK, bool)
    mask[{"none": [], "one": [37], "64 contiguous": list(range(64, BLOCK)),
          "all 128": list(range(BLOCK)), "first alone": [0],
          "last alone": [BLOCK - 1]}[name]] = True
    return W[None], Hinv[None], mask


@pytest.mark.gpu
@pytest.mark.parametrize("name", [
    "none", "one", "64 contiguous", "all 128", "first alone", "last alone",
    "R 1", "R 17", "R 2051", "nb 4 shared Hinv"])
def test_cuda_kernel_edge_cases_on_the_card(cuda_device, name):
    """W and E against float64 and the plain version within 1e-4 (of the
    oracle's largest value; W's residue against the input's when every
    column is pruned), two calls and the sweep in place bitwise equal."""
    W, Hinv, mask = [torch.from_numpy(a).to(cuda_device)
                     for a in edge_case(name)]
    kw, ke = inblock_sweep_kernel(W, Hinv, mask)
    kw2, ke2 = inblock_sweep_kernel(W, Hinv, mask)
    ip = W.clone()
    iw, ie = inblock_sweep_kernel(ip, Hinv, mask, out=ip)
    for a, b in ((kw, kw2), (ke, ke2), (iw, kw), (ie, ke)):
        assert torch.equal(a, b)
    pw, pe = inblock_sweep_plain(W, Hinv, mask)
    gw, ge = inblock_sweep_plain(W.double(), Hinv.double(), mask)
    sw = (W if bool(mask.all()) else gw).abs().max().item()
    for ref in (gw, pw.double()):
        assert (kw.double() - ref).abs().max().item() < RTOL * sw
    if bool(mask.any()):
        for ref in (ge, pe.double()):
            assert (ke.double() - ref).abs().max().item() < \
                RTOL * ge.abs().max().item()
    else:
        assert not ke.any()
