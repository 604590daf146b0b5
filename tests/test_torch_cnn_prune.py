"""PyTorch port vs JAX reference: SPA on the cnn family — groups, the
paper's ``global`` selection with L1 and with SNIP at init, and the
group-convolution coupling the survey names.

On converted weights (``test_torch_cnn.models``: reduced resnet18-cifar
and vgg19-cifar, BN leaves redrawn): the group keys, kinds, unit counts,
protection and every unit's slices equal the JAX package's — the
BatchNorm running statistics (``state.*``) among them, since the eval-mode
forward the trace sees reads them.

Global selection ranks every unit of every group in one list of Python
floats and takes them until their parameters reach the budget, so a
difference of one ulp between two frameworks' sums could swap two units
at the cut.  Every comparison of a pruned set therefore first compares the
unit scores each pruner used (captured from its ``unit_scores``) to
``SCORE_TOL`` of each group's largest score, then asserts, as a stated
precondition of the seeded inputs, that the two scores on either side of
the budget's cut differ by more than twice that, and that no unit was
skipped for its group's minimum; only then are the sets compared.
"""
import numpy as np
import pytest
import torch

import jax
import jax.lax
import jax.numpy as jnp

import repro.core.pruner as j_pruner
import repro.models.cnn as j_cnn
from repro.core.graph import trace_graph as j_trace_graph
from repro.core.groups import build_groups as j_build_groups
from repro.core.pruner import analyze as j_analyze
from repro.core.pruner import prune_model as j_prune_model
from repro.data.synthetic import batches as j_batches
from repro.models import build as j_build
import repro_torch.core.pruner as t_pruner
from repro_torch.core.flops import rf_rp
from repro_torch.core.graph import trace_graph, tree_paths
from repro_torch.core.groups import build_groups
from repro_torch.core.pruner import (_unit_param_count, analyze, leaf_shapes,
                                     prunable, prune_model)
from repro_torch.models import build as t_build
from test_torch_cnn import ARCHS, close_rel, images, models, one_thread  # noqa: F401,E501
from test_torch_pruning import summary

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

SCORE_TOL = 2e-6
_RESULTS: dict = {}


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_groups_match_jax(arch):
    jm, jp, tm, tp = models(arch)
    _, jgroups, _ = j_analyze(jm, jp)
    _, tgroups, _ = analyze(tm, tp)
    assert summary(tgroups) == summary(jgroups)
    paths = {s.path for g in prunable(tgroups) for s in g.units[0].slices}
    assert any(p.startswith("state.") and p.endswith(".mean")
               for p in paths)
    assert any(p.startswith("state.") and p.endswith(".var")
               for p in paths)
    if arch == "resnet18":
        # a stage's residual stream is one group: every block's conv2,
        # bn2 and the next block's conv1 input, across the stage
        res = [g for g in prunable(tgroups)
               if {"params.s0b0.conv2", "params.s0b1.conv2",
                   "params.s1b0.conv1", "params.s1b0.proj"}
               <= {s.path for s in g.units[0].slices}]
        assert len(res) == 1


def _capture(monkeypatch, module, store: list):
    """Record the scores ``module.prune_model`` hands to selection."""
    real = module.unit_scores

    def capturing(*a, **kw):
        out = real(*a, **kw)
        store.append(out)
        return out
    monkeypatch.setattr(module, "unit_scores", capturing)


def global_cut(groups, scores, shapes, ratio):
    """The global selection's walk over the sorted units, as the pruner
    makes it: (score gap across the budget's cut, units skipped for their
    group's minimum before the cut)."""
    weights = {g.key: _unit_param_count(g, shapes) for g in groups}
    total = sum(weights[g.key] * g.n_units for g in groups)
    entries = sorted(((float(s), g.key, u) for g in groups
                      for u, s in enumerate(scores[g.key])),
                     key=lambda e: e[0])
    kept = {g.key: g.n_units for g in groups}
    removed, skipped = 0.0, 0
    for i, (s, key, _) in enumerate(entries):
        if removed >= ratio * total:
            return s - entries[i - 1][0], skipped
        if kept[key] - 1 < 1:
            skipped += 1
            continue
        kept[key] -= 1
        removed += weights[key]
    return float("inf"), skipped


def assert_same_selection(jscores, tscores, groups, shapes, ratio, what,
                          tol=SCORE_TOL):
    """Scores within ``tol`` of each group's largest; the cut's gap above
    twice ``tol`` of the largest score; no unit skipped."""
    assert jscores.keys() == tscores.keys()
    for k in jscores:
        ref = np.asarray(jscores[k])
        np.testing.assert_allclose(tscores[k], ref, rtol=0,
                                   atol=tol * np.abs(ref).max(),
                                   err_msg=f"{what} {k}")
    gap, skipped = global_cut(groups, tscores, shapes, ratio)
    assert gap > 2 * tol * max(np.abs(np.asarray(v)).max()
                               for v in jscores.values()), (
        f"{what}: the seeded inputs put the two scores at the budget's cut "
        f"{gap:.2e} apart, within twice the score tolerance")
    assert skipped == 0, f"{what}: {skipped} units skipped at the minimum"


def _prune(arch, criterion, monkeypatch):
    if (arch, criterion) not in _RESULTS:
        jm, jp, tm, tp = models(arch)
        # the reference's forward under jit (the same function; its trace
        # inlines the call): SNIP's eager gradient takes twice as long
        monkeypatch.setattr(j_cnn, "cnn_forward", jax.jit(
            j_cnn.cnn_forward, static_argnums=(0, 4)))
        js, ts = [], []
        _capture(monkeypatch, j_pruner, js)
        _capture(monkeypatch, t_pruner, ts)
        kw, tkw = {}, {}
        if criterion == "snip":
            b = j_batches(jm.cfg, "id", 1, 8, 0, seed=9)[0]
            kw["grads_batch"] = b
            tkw["grads_batch"] = {k: torch.from_numpy(np.array(v))
                                  for k, v in b.items()}
        jr = j_prune_model(jm, jp, 0.5, criterion=criterion, **kw)
        tr = prune_model(tm, tp, 0.5, criterion=criterion, **tkw)
        _RESULTS[(arch, criterion)] = (jr, tr, js[0], ts[0])
    return _RESULTS[(arch, criterion)]


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_l1_global_matches_jax(arch, monkeypatch):
    """L1 at 0.5 in ``global`` mode (the CNN default): unit scores, the
    pruned set, every pruned tensor bit for bit, the pruned forward, and
    RF / RP above the reference test's 1.15."""
    jm, jp, tm, tp = models(arch)
    jr, tr, js, ts = _prune(arch, "l1", monkeypatch)
    assert tr.report["mode"] == jr.report["mode"] == "global"
    assert_same_selection(js, ts, tr.groups, leaf_shapes(tp), 0.5, "l1")
    assert tr.pruned_units == jr.pruned_units
    assert tr.cfg == tm.cfg                     # widths live in the tensors
    jl = dict(tree_paths(jax.tree.map(np.asarray, jr.params)))
    for path, leaf in tree_paths(tr.params):
        np.testing.assert_array_equal(leaf.numpy(), jl[path], err_msg=path)
    # global selection leaves stages (and blocks) at different widths
    widths = {tuple(leaf.shape) for path, leaf in tree_paths(tr.params)
              if path.endswith(".conv2") or path.endswith(".conv")}
    assert len(widths) > len(tm.cfg.cnn_stages)
    x = images(jm.cfg, seed=5)
    ref = np.asarray(j_build(jr.cfg).forward(jr.params,
                                             {"images": jnp.asarray(x)}))
    with torch.no_grad():
        got = t_build(tr.cfg).forward(tr.params,
                                      {"images": torch.from_numpy(x)})
    close_rel(got, ref)
    batch = {"images": torch.from_numpy(x)}
    r = rf_rp(tm, tp, t_build(tr.cfg), tr.params, batch)
    assert r["RF"] > 1.15 and r["RP"] > 1.15, r


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_snip_at_init_matches_jax(arch, monkeypatch):
    """SPA-SNIP (|g·θ| from ``torch.func.grad`` of the eval-mode loss on
    one batch) at init, global: the same scores and the same units."""
    jr, tr, js, ts = _prune(arch, "snip", monkeypatch)
    assert_same_selection(js, ts, tr.groups, leaf_shapes(models(arch)[3]),
                          0.5, "snip")
    assert tr.pruned_units == jr.pruned_units
    assert tr.report["units_pruned"] == jr.report["units_pruned"]


# ---------------------------------------------------------------------------
# Group convolutions: a toy model traced in both packages
# ---------------------------------------------------------------------------

TOY = {"conv1": (3, 3, 2, 8), "conv2": (3, 3, 1, 8), "conv3": (1, 1, 8, 6),
       "fc": (6, 5)}


def _j_toy(p, x):
    def conv(h, w, groups):
        return jax.lax.conv_general_dilated(
            h, w, (1, 1), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"),
            feature_group_count=groups)
    h = jax.nn.relu(conv(x, p["conv1"], 2))          # 2 groups of 2 -> 4
    h = jax.nn.relu(conv(h, p["conv2"], 8))          # depthwise
    h = jax.nn.relu(conv(h, p["conv3"], 1))
    return jnp.mean(h, axis=(1, 2)) @ p["fc"]


def _t_toy(p, x):
    def conv(h, w, groups):
        pad = w.shape[0] // 2
        return torch.nn.functional.conv2d(
            h.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), padding=pad,
            groups=groups).permute(0, 2, 3, 1)
    h = torch.relu(conv(x, p["conv1"], 2))
    h = torch.relu(conv(h, p["conv2"], 8))
    h = torch.relu(conv(h, p["conv3"], 1))
    return h.mean(dim=(1, 2)) @ p["fc"]


def test_group_convolution_coupling_matches_jax():
    """A conv with ``groups=2`` and a depthwise one: the groups the two
    packages' mask propagation finds are equal.  A unit of the grouped
    conv's output is its whole group (4 output channels and the group's
    inputs), carried through the depthwise conv (which couples its input
    and output channels) into the 1x1 conv's input; it reaches the input
    images' channels, so it is protected."""
    rng = np.random.default_rng(0)
    jp = {k: jnp.asarray(rng.standard_normal(s).astype(np.float32))
          for k, s in TOY.items()}
    x = rng.standard_normal((2, 6, 6, 4)).astype(np.float32)
    jgroups = j_build_groups(j_trace_graph(_j_toy, jp, jnp.asarray(x)))
    tp = {k: torch.from_numpy(np.asarray(v).copy()) for k, v in jp.items()}
    tgroups = build_groups(trace_graph(_t_toy, tp, torch.from_numpy(x)))
    assert summary(tgroups) == summary(jgroups)
    by_key = {g.key: g for g in tgroups}
    grouped = by_key["conv1:3"]
    assert grouped.n_units == 2 and grouped.protected
    assert [(s.path, s.axis, s.positions) for s in grouped.units[1].slices
            ] == [("conv1", 2, (0, 1)), ("conv1", 3, (4, 5, 6, 7)),
                  ("conv2", 3, (4, 5, 6, 7)), ("conv3", 2, (4, 5, 6, 7))]
    assert by_key["conv3:3"].n_units == 6 and not by_key["conv3:3"].protected
    np.testing.assert_allclose(
        _t_toy(tp, torch.from_numpy(x)).numpy(),
        np.asarray(_j_toy(jp, jnp.asarray(x))), rtol=1e-5, atol=1e-5)
