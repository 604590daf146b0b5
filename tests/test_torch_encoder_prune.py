"""PyTorch port vs JAX reference: SPA on the audio and vlm families —
groups, L1 and SNIP at init on reduced hubert-xlarge, vit-mini,
distilbert-mini and paligemma-3b (MQA: its single KV head); OBSPA:
``test_torch_encoder_obspa.py``.

On converted weights (``test_torch_encoder.models``): the group keys,
kinds, unit counts, protection (``frame_proj`` / ``vision_proj`` on the
residual axis) and every unit's slices equal the JAX package's; L1 at 0.5
prunes the same units, reads back the same config and leaves the same
weights bit for bit.  Per-group selection takes the lowest-scoring units
of each group, so before a pruned set is compared the unit scores each
pruner used (captured from its ``unit_scores``) are held to a tolerance
of each group's largest score, and the two scores on either side of every
group's cut are asserted to differ by more than twice that (a
precondition of the seeded inputs).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax

import repro.core.pruner as j_pruner
import repro.models.transformer as j_tf
from repro.core.pruner import analyze as j_analyze
from repro.core.pruner import prune_model as j_prune_model
from repro.data.synthetic import batches as j_batches
from repro.models import build as j_build
from repro_torch import convert
import repro_torch.core.pruner as t_pruner
from repro_torch.core.flops import rf_rp
from repro_torch.core.graph import tree_paths
from repro_torch.core.pruner import analyze, prunable, prune_model
from repro_torch.models import build as t_build
from test_torch_encoder import J, T, models
from test_torch_pruning import summary

torch.backends.cuda.matmul.allow_tf32 = False

ARCHS = ("hubert", "vit", "distilbert", "paligemma-3b")
SCORE_TOL = 2e-6
_RESULTS: dict = {}


def seq_of(cfg, text: int = 12) -> int:
    return cfg.vision_tokens + text if cfg.family == "vlm" else text


def assert_same_cuts(jscores, tscores, groups, ratio, what, tol):
    """Scores within ``tol`` of each group's largest, and at every group's
    per-group cut (the lowest ``round(n · ratio)`` units go) the two
    scores either side more than ``2 · tol`` of the largest apart."""
    assert jscores.keys() == tscores.keys()
    for g in groups:
        ref = np.asarray(jscores[g.key], np.float64)
        got = np.asarray(tscores[g.key], np.float64)
        top = np.abs(ref).max()
        np.testing.assert_allclose(got, ref, rtol=0, atol=tol * top,
                                   err_msg=f"{what} {g.key}")
        cut = g.n_units - max(g.n_units - int(round(g.n_units * ratio)), 1)
        if 0 < cut < g.n_units:
            s = np.sort(got)
            assert s[cut] - s[cut - 1] > 2 * tol * top, (
                f"{what} {g.key}: the seeded inputs put two units at the "
                f"cut {s[cut] - s[cut - 1]:.2e} apart")


def _capture(monkeypatch, module, name: str, store: list):
    real = getattr(module, name)

    def capturing(*a, **kw):
        out = real(*a, **kw)
        store.append(out)
        return out
    monkeypatch.setattr(module, name, capturing)


@pytest.mark.parametrize("arch", ["hubert", "vit", "paligemma-3b"])
def test_groups_match_jax(arch):
    """Keys, kinds, units, protection and slices; the front ends' residual
    axis protected; heads and MLP channels prunable (paligemma: query heads
    within its single KV head).  distilbert-mini's groups are vit-mini's
    but for the head's columns (its L1 case compares the pruned set)."""
    jm, jp, tm, tp = models(arch)
    _, jgroups, _ = j_analyze(jm, jp)
    _, tgroups, _ = analyze(tm, tp)
    assert summary(tgroups) == summary(jgroups)
    front = "frame_proj" if tm.cfg.family == "audio" else "vision_proj"
    prot = [g for g in tgroups if g.protected
            and any(s.path == front and s.axis == 1
                    for s in g.units[0].slices)]
    assert len(prot) == 1
    assert {g.kind for g in prunable(tgroups)} == {"heads", "mlp"}


def _l1(arch):
    if ("l1", arch) not in _RESULTS:
        jm, jp, tm, tp = models(arch)
        _RESULTS[("l1", arch)] = (j_prune_model(jm, jp, 0.5, criterion="l1"),
                                  prune_model(tm, tp, 0.5, criterion="l1"))
    return _RESULTS[("l1", arch)]


@pytest.mark.parametrize("arch", ARCHS)
def test_l1_units_config_and_weights_match_jax(arch):
    jm, jp, tm, tp = models(arch)
    jr, tr = _l1(arch)
    assert tr.pruned_units == jr.pruned_units
    assert tr.report["units_pruned"] == jr.report["units_pruned"]
    assert tr.cfg == convert.convert_config(dataclasses.asdict(jr.cfg))
    c = tr.cfg
    assert (c.n_heads, c.d_ff) == (tm.cfg.n_heads // 2, tm.cfg.d_ff // 2)
    assert c.n_kv_heads == (1 if arch == "paligemma-3b" else c.n_heads)
    jleaves = dict(tree_paths(jax.tree.map(np.asarray, jr.params)))
    for path, leaf in tree_paths(tr.params):
        np.testing.assert_array_equal(leaf.numpy(), jleaves[path],
                                      err_msg=path)
    assert sum(t.numel() for _, t in tree_paths(tr.params)) == \
        c.param_count()
    b = tm.dummy_batch(2, seq_of(tm.cfg), device="cpu")
    ref = np.asarray(j_build(jr.cfg).forward(
        jr.params, J({k: v.numpy() for k, v in b.items()})))
    with torch.no_grad():
        got = t_build(c).forward(tr.params, b)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=0)
    r = rf_rp(tm, tp, t_build(c), tr.params, b)
    assert r["RF"] > 1.15 and r["RP"] > 1.15, r


def _snip(arch, monkeypatch):
    if ("snip", arch) not in _RESULTS:
        jm, jp, tm, tp = models(arch)
        # the reference's loss under jit (the same function; its eager
        # gradient compiles op by op, 13-20 s here)
        monkeypatch.setattr(j_tf, "loss_fn", jax.jit(
            j_tf.loss_fn, static_argnums=(1, 3)))
        js, ts = [], []
        _capture(monkeypatch, j_pruner, "unit_scores", js)
        _capture(monkeypatch, t_pruner, "unit_scores", ts)
        b = j_batches(jm.cfg, "id", 1, 4, seq_of(jm.cfg), seed=9)[0]
        jr = j_prune_model(jm, jp, 0.5, criterion="snip", grads_batch=b)
        tr = prune_model(tm, tp, 0.5, criterion="snip",
                         grads_batch=T(b))
        _RESULTS[("snip", arch)] = (jr, tr, js[0], ts[0])
    return _RESULTS[("snip", arch)]


@pytest.mark.parametrize("arch", ["hubert", "vit", "paligemma-3b"])
def test_snip_at_init_matches_jax(arch, monkeypatch):
    """SPA-SNIP (|g·θ| of the encoder's per-frame or pooled loss, or the
    vlm's text-position loss, by ``torch.func.grad``) at init: the same
    scores and, past the cut's gap, the same units and config."""
    jr, tr, js, ts = _snip(arch, monkeypatch)
    assert_same_cuts(js, ts, tr.groups, 0.5, "snip", SCORE_TOL)
    assert tr.pruned_units == jr.pruned_units
    assert tr.cfg == convert.convert_config(dataclasses.asdict(jr.cfg))
