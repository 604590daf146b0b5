"""PyTorch port vs JAX reference: OBSPA pruning and the calibration data.

On converted weights and the same calibration batches (numpy-drawn, so
identical token for token) the port's ``obspa_prune`` must prune the same
units as the JAX package's and reconstruct the same weights within 1e-4
relative (the sweep's tolerance; Hessians differ in f32 summation order).
The reference's system checks are mirrored: OBSPA beats plain magnitude
pruning on logits, every reconstructed layer's output error is below plain
slicing of the same columns, each calibration mode gives a finite model, and
the single-layer closed form holds.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax

from repro.configs import get_config as j_get_config, reduced as j_reduced
from repro.core.obspa import obspa_prune as j_obspa_prune
from repro.data.synthetic import batches as j_batches
from repro.models import build as j_build
from repro_torch import convert
from repro_torch.configs import get_config, reduced
from repro_torch.core.graph import tree_paths
from repro_torch.core.obspa import layer_output_errors, obspa_prune
from repro_torch.core.pruner import prune_model
from repro_torch.data import synthetic
from repro_torch.data.synthetic import batches
from repro_torch.kernels.obspa_update import sweep_oracle
from repro_torch.models import build

torch.backends.cuda.matmul.allow_tf32 = False

_CASES: dict = {}


def case(kv: int):
    """(JAX model, JAX params, port model, port params, JAX calibration,
    port calibration) for reduced tinyllama with ``kv`` KV heads."""
    if kv not in _CASES:
        jcfg = j_reduced(j_get_config("tinyllama-1.1b")).replace(
            n_kv_heads=kv)
        jm = j_build(jcfg)
        jp = jm.init(jax.random.PRNGKey(0))
        tcfg = convert.convert_config(dataclasses.asdict(jcfg))
        tp = convert.convert_params(jax.tree.map(np.asarray, jp))
        jc = j_batches(jcfg, "id", 4, 8, 16, seed=1, with_targets=False)
        tc = batches(tcfg, "id", 4, 8, 16, seed=1, device="cpu")
        _CASES[kv] = (jm, jp, build(tcfg), tp, jc, tc)
    return _CASES[kv]


@pytest.mark.parametrize("kv", [1, 2])
def test_obspa_matches_jax(kv):
    jm, jp, tm, tp, jc, tc = case(kv)
    jr = j_obspa_prune(jm, jp, 0.5, jc, recalibrate=False)
    tr = obspa_prune(tm, tp, 0.5, tc)
    assert tr.pruned_units == jr.pruned_units
    assert tr.report["groups_with_obs"] == jr.report["groups_with_obs"]
    assert tr.cfg == convert.convert_config(dataclasses.asdict(jr.cfg))
    jleaves = dict(tree_paths(jax.tree.map(np.asarray, jr.params)))
    for path, leaf in tree_paths(tr.params):
        ref = jleaves[path]
        assert leaf.shape == ref.shape, path
        err = np.abs(leaf.numpy() - ref).max() / (np.abs(ref).max() + 1e-12)
        assert err < 1e-4, (path, err)
    assert set(tr.report["seconds"]) == {"trace", "group", "hessians",
                                         "inverse", "score", "sweep",
                                         "slice"}


def _logit_mse(m, p, m2, p2, evalb):
    with torch.no_grad():
        a = m.forward(p, evalb).float()
        b = m2.forward(p2, evalb).float()
    return float(((a - b) ** 2).mean())


def test_reconstruction_beats_naive():
    _, _, tm, tp, _, tc = case(2)
    evalb = batches(tm.cfg, "id", 1, 8, 16, seed=99, device="cpu")[0]
    naive = prune_model(tm, tp, 0.5, criterion="l1")
    ob = obspa_prune(tm, tp, 0.5, tc)
    e_naive = _logit_mse(tm, tp, build(naive.cfg), naive.params, evalb)
    e_ob = _logit_mse(tm, tp, build(ob.cfg), ob.params, evalb)
    assert e_ob < e_naive, (e_ob, e_naive)
    errs = layer_output_errors(tm, tp, ob, tc)
    # wo and w_down of both layers
    assert len(errs) == 2 * tm.cfg.num_layers
    for name, (e_obspa, e_cut) in errs.items():
        assert 0 <= e_obspa < e_cut, (name, e_obspa, e_cut)


@pytest.mark.parametrize("mode", ["id", "ood", "datafree"])
def test_calibration_modes(mode):
    cfg = reduced(get_config("tinyllama-1.1b"))
    m = build(cfg)
    params = m.init(0, device="cpu")
    calib = batches(cfg, mode, 3, 4, 16, seed=1, device="cpu")
    res = obspa_prune(m, params, 0.5, calib, calib_mode=mode)
    evalb = batches(cfg, "id", 1, 4, 16, seed=7, device="cpu")[0]
    with torch.no_grad():
        out = build(res.cfg).forward(res.params, evalb)
    assert torch.isfinite(out).all()
    assert res.report["calib_mode"] == mode and res.cfg.d_ff == cfg.d_ff // 2


def test_reconstruction_exact_single_layer():
    """For one linear layer, pruning an input channel with OBSPA must match
    the closed-form least-squares compensation."""
    rng = np.random.default_rng(0)
    K, R, N = 16, 8, 512
    W = rng.normal(size=(K, R)).astype(np.float32)       # x @ W
    X = rng.normal(size=(N, K)).astype(np.float32)
    H = X.T @ X / N
    lam = 0.01 * np.trace(H) / K
    Hinv = np.linalg.inv(H + lam * np.eye(K, dtype=np.float32))
    mask = np.zeros(K, bool)
    mask[2] = True
    Wt = sweep_oracle(W.T, Hinv, mask)                    # (R, K) view
    # paper Eq. 13/14 single-column closed form
    err = W.T[:, 2] / Hinv[2, 2]
    expect = W.T.copy()
    expect[:, 2:] -= err[:, None] * Hinv[2, 2:][None]
    np.testing.assert_allclose(Wt, expect, rtol=1e-5, atol=1e-5)
    from repro_torch.kernels.obspa_update import obspa_sweep
    got = obspa_sweep(torch.from_numpy(np.ascontiguousarray(W.T)),
                      torch.from_numpy(Hinv.astype(np.float32)),
                      torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), expect, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", ["id", "ood", "datafree", "eval"])
def test_batches_identical_to_jax(mode):
    jcfg = j_reduced(j_get_config("tinyllama-1.1b"))
    tcfg = convert.convert_config(dataclasses.asdict(jcfg))
    jb = j_batches(jcfg, mode, 3, 4, 12, seed=2, with_targets=False,
                   task_seed=1)
    tb = batches(tcfg, mode, 3, 4, 12, seed=2, task_seed=1, device="cpu")
    assert len(tb) == 3
    for a, b in zip(jb, tb):
        assert set(b) == {"tokens"} and b["tokens"].dtype == torch.int32
        np.testing.assert_array_equal(b["tokens"].numpy(),
                                      np.asarray(a["tokens"]))


def test_datafree_never_builds_the_task(monkeypatch):
    """At a 32000-token vocabulary the Markov task's matrix alone is 8 GB;
    data-free calibration never samples from it, so it is never built."""
    def refuse(*a, **k):
        raise AssertionError("MarkovLM built for data-free calibration")

    monkeypatch.setattr(synthetic, "MarkovLM", refuse)
    cfg = get_config("tinyllama-1.1b")
    out = batches(cfg, "datafree", 2, 4, 512, seed=5, device="cpu")
    assert out[0]["tokens"].shape == (4, 512)
    assert int(out[1]["tokens"].max()) < cfg.vocab_size
    with pytest.raises(AssertionError, match="MarkovLM built"):
        batches(cfg, "id", 1, 1, 4, device="cpu")


def test_batches_default_to_the_cuda_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        batches(reduced(get_config("tinyllama-1.1b")), "datafree", 1, 1, 4)
