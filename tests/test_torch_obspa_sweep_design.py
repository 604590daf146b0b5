"""The Hopper design of the OBSPA in-block sweep K4, emulated on the CPU.

The CUDA kernel has no interpret mode, so its arithmetic is modelled here in
plain PyTorch (``emulate``), as the kernel does it:

- the mask as four 32-bit ballot words, one per quarter of the 128-column
  block, and within a quarter only the set bits walked, lowest first;
- the Hinv rows of the pruned columns staged in compacted order (slot c =
  the count of pruned columns before j), each from its own quarter on; the
  rest of the staging buffer is NaN here, so a read of it would show;
- err = w_j * (1 / Hinv[j, j]) with the reciprocal rounded once, and the
  update as one FMA (the product taken in float64, which holds it exactly,
  and the difference rounded to f32 once);
- the rows grouped as ``plan`` lays them out, rows past R loaded as zeros
  and stored nowhere; the output may alias the input.

The model is held to the JAX ``inblock_sweep`` (Pallas interpret mode), the
JAX ``obspa_sweep`` (with the model run as the port's in-block kernel), the
float64 ``sweep_oracle`` and the plain version, with the reference's
tolerance: error relative to ``|oracle|.max()`` below 1e-4
(``tests/test_kernels.py``).  ``plan`` and ``check_args`` are held to every
shape the repo runs.  The card runs the kernel itself against the plain
version (``tests/test_torch_obspa_sweep.py::
test_cuda_kernel_vs_plain_on_the_card``, marked ``gpu``, and
``chip_smoke.py`` phase 6).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.obspa_update import obspa_sweep as j_sweep
from repro.kernels.obspa_update.obspa_update import (
    inblock_sweep as j_inblock)
from repro_torch.configs import get_config, reduced
from repro_torch.kernels.obspa_update import (
    BLOCK, inblock_sweep_plain, obspa_sweep_batched, sweep_oracle)
from repro_torch.kernels.obspa_update import ops
from repro_torch.kernels.obspa_update.obspa_update import (
    MAX_SMEM, check_args, plan)
from test_torch_obspa_sweep import make_case

RTOL = 1e-4
# what the model meets against the plain version (a divide and a multiply
# and subtract, where it multiplies by the reciprocal and takes one FMA),
# relative to |plain|.max(); at these cases 4.8e-8 to 3.0e-7
TIGHT = 1e-6


@pytest.fixture(autouse=True)
def _one_thread():
    """Many small tensor operations: one intra-op thread keeps them from
    contending for the cores with the other test workers (restored after
    each test)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def ballot_words(mask: torch.Tensor) -> list[int]:
    """The four words __ballot_sync gives: bit l of word k is mask[32k+l]."""
    m = mask.bool().tolist()
    return [sum(1 << l for l in range(32) if m[32 * k + l]) for k in range(4)]


def set_bits(word: int) -> list[int]:
    """The walk of one quarter: j = ffs(bits) - 1; bits &= bits - 1."""
    out = []
    while word:
        out.append((word & -word).bit_length() - 1)
        word &= word - 1
    return out


def stage(h: torch.Tensor, words: list[int]) -> torch.Tensor:
    """The staging buffer: the row of the c-th pruned column in slot c, from
    its quarter's first column on; NaN wherever nothing is copied."""
    hs = torch.full((BLOCK, BLOCK), float("nan"))
    c = 0
    for k in range(4):
        for jj in set_bits(words[k]):
            hs[c, 32 * k:] = h[32 * k + jj, 32 * k:]
            c += 1
    return hs


def emulate(w: torch.Tensor, hinv: torch.Tensor, mask: torch.Tensor,
            out: torch.Tensor | None = None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """(updated w, E) by the kernel's arithmetic.  w (nb, R, 128) f32, hinv
    (nb or 1, 128, 128), mask (128,); ``out`` may be ``w`` itself."""
    nb, R, _ = w.shape
    pl = plan(R, nb)
    Rp = pl.blocks * pl.warps * pl.rows_per_warp
    words = ballot_words(mask)
    out = torch.empty_like(w) if out is None else out
    e = torch.empty_like(w)
    for b in range(nb):
        h = hinv[b if hinv.shape[0] == nb else 0]
        rinv = 1.0 / torch.diagonal(h)                 # f32, rounded once
        regs = torch.zeros(Rp, BLOCK)                  # rows past R: zeros
        regs[:R] = w[b]
        er = torch.zeros(Rp, BLOCK)
        hs = stage(h, words)
        c = 0
        for kk in range(4):
            q = slice(32 * kk, BLOCK)
            for jj in set_bits(words[kk]):
                j = 32 * kk + jj
                hr = hs[c, q].clone()
                c += 1
                hr[:jj] = 0.0                          # lanes left of j
                err = regs[:, j] * rinv[j]             # lane j's product
                er[:, j] = err
                regs[:, q] = (regs[:, q].double() - err.double()[:, None]
                              * hr.double()).float()   # one FMA
        out[b] = regs[:R]                              # rows past R: none
        e[b] = er[:R]
    return out, e


def rel(a, gold, scale=None) -> float:
    """max|a - gold| over |gold|.max() (or over ``scale``)."""
    a, gold = np.asarray(a, np.float64), np.asarray(gold, np.float64)
    if scale is None:
        scale = np.abs(gold).max()
    return float(np.abs(a - gold).max() / max(scale, 1e-30))


def inblock_oracle(W, Hinv, mask):
    """(W, E) of one block in float64, the reference's loop."""
    W = np.array(W, np.float64)
    H = np.asarray(Hinv, np.float64)
    E = np.zeros_like(W)
    for j in np.nonzero(mask)[0]:
        E[:, j] = W[:, j] / H[j, j]
        W[:, j:] -= E[:, j, None] * H[j, None, j:]
    return W, E


def held(mw, me, W, Hinv, mask, pw, pe):
    """The model's (W, E) against float64 within the reference's 1e-4, and
    against the plain version within TIGHT.  Relative to the oracle's
    largest value; when every column is pruned, W's oracle is zero and its
    residue is taken relative to the input's scale."""
    gw, ge = inblock_oracle(W, Hinv, mask)
    sw = np.abs(W).max() if mask.all() else None
    assert rel(mw, gw, sw) < RTOL
    assert rel(mw, pw, sw) < TIGHT
    if mask.any():
        assert rel(me, ge) < RTOL and rel(me, pe) < TIGHT
    else:
        assert not np.asarray(me).any()


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def masks() -> dict:
    """The design's edge cases of one block's mask."""
    rng = np.random.default_rng(0)
    one = np.zeros(BLOCK, bool)
    one[rng.integers(BLOCK)] = True
    head = np.zeros(BLOCK, bool)
    head[64:] = True
    first, last = np.zeros(BLOCK, bool), np.zeros(BLOCK, bool)
    first[0] = last[-1] = True
    return {"none": np.zeros(BLOCK, bool), "one": one, "64 contiguous": head,
            "all 128": np.ones(BLOCK, bool), "first alone": first,
            "last alone": last, "half": rng.random(BLOCK) < 0.5}


MASKS = masks()


def test_ballot_words_and_compacted_slots():
    m = torch.zeros(BLOCK, dtype=torch.bool)
    m[[0, 31, 32, 70, 127]] = True
    words = ballot_words(m)
    assert words == [1 | 1 << 31, 1, 1 << 6, 1 << 31]
    assert [set_bits(wd) for wd in words] == [[0, 31], [0], [6], [31]]
    h = torch.arange(BLOCK * BLOCK, dtype=torch.float32).view(BLOCK, BLOCK)
    hs = stage(h, words)
    for c, j in enumerate([0, 31, 32, 70, 127]):
        k = j // 32
        assert torch.equal(hs[c, 32 * k:], h[j, 32 * k:])
        assert torch.isnan(hs[c, :32 * k]).all()
    assert torch.isnan(hs[5:]).all()


@pytest.mark.parametrize("name", sorted(MASKS))
def test_model_vs_jax_interpret_oracle_and_plain(name):
    """One 70-row block (two warps' worth of tail past it) against the
    Pallas kernel in interpret mode, float64 and the plain version."""
    W, Hinv, _ = make_case(5, 70, BLOCK, 0.0)
    mask = MASKS[name]
    mw, me = emulate(t(W)[None], t(Hinv)[None], t(mask))
    assert torch.isfinite(mw).all() and torch.isfinite(me).all()
    jw, je = j_inblock(jnp.asarray(W), jnp.asarray(Hinv), jnp.asarray(mask),
                       row_block=32, interpret=True)
    pw, pe = inblock_sweep_plain(t(W)[None], t(Hinv)[None], t(mask))
    held(mw[0], me[0], W, Hinv, mask, pw[0], pe[0])
    sw = np.abs(W).max() if mask.all() else None
    assert rel(mw[0], jw, sw) < RTOL
    if mask.any():
        assert rel(me[0], je) < RTOL
    assert not me[0][:, ~mask].any()
    if not mask.any():
        assert torch.equal(mw[0], t(W))


@pytest.mark.parametrize("R", [1, 17, 2051])
def test_model_rows_and_tails(R):
    """R 1 and 17 (one and two blocks, most warps past R) and 2051 (the
    main path's 2048 and a tail of 3 rows in a last block of 16)."""
    W, Hinv, mask = make_case(R, R, BLOCK, 0.5)
    pl = plan(R, 1)
    assert pl.blocks * pl.warps * pl.rows_per_warp >= R
    mw, me = emulate(t(W)[None], t(Hinv)[None], t(mask))
    pw, pe = inblock_sweep_plain(t(W)[None], t(Hinv)[None], t(mask))
    held(mw[0], me[0], W, Hinv, mask, pw[0], pe[0])


def test_model_batched_with_a_shared_hinv():
    """nb 4 with one Hinv block for every entry (the launch's h_bs = 0)."""
    W, _, mask = make_case(8, 24, BLOCK, 0.5, nb=4)
    _, Hinv, _ = make_case(9, 4, BLOCK, 0.5)
    mw, me = emulate(t(W), t(Hinv)[None], t(mask))
    pw, pe = inblock_sweep_plain(t(W), t(Hinv)[None], t(mask))
    for b in range(4):
        held(mw[b], me[b], W[b], Hinv, mask, pw[b], pe[b])


def test_model_output_aliasing_its_input():
    """out = w: every row is read whole before it is written, so the sweep
    in place gives the bits of the sweep into a new tensor."""
    W, Hinv, mask = make_case(10, 40, BLOCK, 0.5)
    fresh = emulate(t(W)[None], t(Hinv)[None], t(mask))
    w = t(W.copy())[None]
    new, e = emulate(w, t(Hinv)[None], t(mask), out=w)
    assert new.data_ptr() == w.data_ptr()
    assert torch.equal(w, fresh[0]) and torch.equal(e, fresh[1])


def test_model_as_the_sweeps_kernel_vs_jax(monkeypatch):
    """The blocked sweep (one E buffer, the compensation by baddbmm_ into
    the rest in place) with the model as its in-block kernel, against the
    JAX obspa_sweep and float64, over three blocks with a padded tail."""
    W, Hinv, mask = make_case(11, 33, 300, 0.5)

    def model_inblock(w, hinv, m, out=None, e_out=None):
        w3, h3, o3, e3 = check_args(w, hinv, m, out, e_out)
        new, e = emulate(w3.clone(), h3, m)
        return o3.copy_(new), e3.copy_(e)

    monkeypatch.setattr(ops, "inblock_sweep", model_inblock)
    out = obspa_sweep_batched(t(W)[None], t(Hinv)[None], t(mask))[0]
    gold = sweep_oracle(W, Hinv, mask)
    assert rel(out, gold) < RTOL
    assert rel(out, np.asarray(j_sweep(W, Hinv, mask))) < RTOL


def test_one_e_buffer_and_the_compensation_in_place():
    """The port's blocked sweep (plain in-block version on the CPU) with an
    Hinv view off the 16-byte grid: the sweep copies it once, and matches
    the aligned run bit for bit."""
    W, Hinv, mask = make_case(12, 20, 256, 0.5)
    buf = torch.zeros(256 * 256 + 1)
    off = buf[1:].view(256, 256).copy_(t(Hinv))
    assert off.data_ptr() % 16
    a = obspa_sweep_batched(t(W)[None], t(Hinv)[None], t(mask))
    b = obspa_sweep_batched(t(W)[None], off[None], t(mask))
    assert torch.equal(a, b)
    assert rel(a[0], sweep_oracle(W, Hinv, mask)) < RTOL


def _views(R, K, nb=1, shared=False):
    """What the sweep passes the kernel: column-block views of a padded W
    and Hinv (row stride Kp), the mask and one E buffer."""
    Kp = -(-K // BLOCK) * BLOCK
    Wp = torch.zeros(nb, R, Kp)
    Hp = torch.zeros(1 if shared else nb, Kp, Kp)
    mask = torch.zeros(Kp, dtype=torch.bool)
    e = torch.empty(nb, R, BLOCK)
    for b0 in range(0, Kp, BLOCK):
        blk = slice(b0, b0 + BLOCK)
        yield Wp[:, :, blk], Hp[:, blk, blk], mask[blk], e


def repo_shapes():
    """(R, K, nb) of every consumer the repo sweeps: TinyLlama's wo and
    w_down at full width and reduced, and batched cases (experts)."""
    out = []
    for cfg in (get_config("tinyllama-1.1b"),
                reduced(get_config("tinyllama-1.1b"))):
        out += [(cfg.d_model, cfg.n_heads * cfg.v_head_dim_, 1),
                (cfg.d_model, cfg.d_ff, 1)]
    return out + [(96, 300, 4), (768, 256, 64)]


@pytest.mark.parametrize("R,K,nb", repo_shapes())
def test_plan_and_check_args_take_the_repo_shapes(R, K, nb):
    pl = plan(R, nb)
    assert pl.rows_per_warp == 2 and pl.smem_bytes <= MAX_SMEM
    assert (pl.blocks - 1) * pl.warps * pl.rows_per_warp < R \
        <= pl.blocks * pl.warps * pl.rows_per_warp
    for shared in (False, True) if nb > 1 else (False,):
        for w, h, m, e in _views(R, K, nb, shared):
            check_args(w, h, m, out=w, e_out=e)


def test_plan_at_the_main_path_and_its_limits():
    """Two rows a warp, 8 warps a block: R 2048 in 128 blocks, R 1 and 17
    in one and two; nb rides on grid y, at most 65535."""
    assert plan(2048) == (2, 8, 128, BLOCK * BLOCK * 4 + 32)
    assert plan(2051).blocks == 129
    assert plan(1).blocks == plan(16).blocks == 1 and plan(17).blocks == 2
    assert plan(768, 64).blocks == 48
    for R, nb in ((0, 1), (8, 0), (8, 65536)):
        with pytest.raises(ValueError, match="65535"):
            plan(R, nb)


def test_check_args_refuses_hinv_off_the_16_byte_grid():
    w = torch.zeros(8, BLOCK)
    m = torch.zeros(BLOCK, dtype=torch.bool)
    buf = torch.zeros(BLOCK * (BLOCK + 1) + 4)
    with pytest.raises(ValueError, match="16 bytes"):
        check_args(w, buf[1:1 + BLOCK * BLOCK].view(BLOCK, BLOCK), m)
    with pytest.raises(ValueError, match="16 bytes"):
        check_args(w, buf.as_strided((BLOCK, BLOCK), (BLOCK + 1, 1)), m)
    h3 = torch.zeros(2 * BLOCK * BLOCK + 2).as_strided(
        (2, BLOCK, BLOCK), (BLOCK * BLOCK + 2, BLOCK, 1))
    with pytest.raises(ValueError, match="16 bytes"):
        check_args(torch.zeros(2, 8, BLOCK), h3, m)
    with pytest.raises(ValueError, match="contiguous"):
        check_args(w, torch.eye(BLOCK), m,
                   e_out=torch.zeros(16, BLOCK)[::2])
    check_args(w, buf[4:4 + BLOCK * BLOCK].view(BLOCK, BLOCK), m)
