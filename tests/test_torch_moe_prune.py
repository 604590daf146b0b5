"""PyTorch port vs JAX reference: pruning the moe family — SPA grouping
with the reference's ``MOE_HINTS``, magnitude pruning, and OBSPA with the
experts' ``w_down`` as batched consumers (one Hessian per expert; all
experts in one sweep).

On converted weights (``test_torch_moe.models``): the group keys (with the
merged ``router:1+hint`` group of whole experts), kinds, unit counts,
protection and every unit's slices equal the JAX package's on reduced
qwen2-moe (shared experts) and reduced qwen3-moe (qk_norm, GQA); L1 at 0.5
prunes the same units, reads back the same config (experts, expert width,
shared width) and leaves the same weights bit for bit.  OBSPA on reduced
qwen2-moe, on the same calibration batches: the same consumers (``attn.wo``,
the experts' and the shared experts' ``w_down``), units, config and weights
within 1e-4 relative, and every consumer's layer-output error at the same
ratio to plain slicing as the reference's reconstruction leaves it (1e-3).
Logits are compared only after the routing precondition of
``test_torch_moe`` holds.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core.obspa import find_consumers as j_find_consumers
from repro.core.obspa import obspa_prune as j_obspa_prune
from repro.core.pruner import analyze as j_analyze, prunable as j_prunable
from repro.core.pruner import prune_model as j_prune_model
from repro.data.synthetic import batches as j_batches
from repro.models import build as j_build
from repro.models import moe as j_moe
from repro_torch import convert
from repro_torch.core.graph import tree_paths
from repro_torch.core.obspa import (find_consumers, layer_output_errors,
                                    obspa_prune)
from repro_torch.core.pruner import (analyze, group_graph, prunable,
                                     prune_model, trace_model)
from repro_torch.data.synthetic import batches
from repro_torch.models import build as t_build
from repro_torch.models import moe as t_moe
from test_torch_moe import (ARCHS, _captured_moe_inputs, _layer_params,
                            assert_same_routing, close, models, one_thread,
                            T)  # noqa: F401
from test_torch_obspa_ssm import _consumer_table
from test_torch_pruning import summary

torch.backends.cuda.matmul.allow_tf32 = False

_RESULTS: dict = {}


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_groups_match_jax(arch):
    """``tests/test_pruning.py::test_moe_hint_merges_router``, held to the
    JAX package's groups: keys, kinds, units, protection and slices."""
    jm, jp, tm, tp = models(arch)
    _, jgroups, _ = j_analyze(jm, jp)
    _, tgroups, _ = analyze(tm, tp)
    assert summary(tgroups) == summary(jgroups)
    experts = [g for g in prunable(tgroups) if g.kind == "expert"
               and g.key.endswith("router:1+hint")]
    assert len(experts) == tm.cfg.num_layers
    for g in experts:
        assert g.n_units == tm.cfg.n_experts
        leaves = {s.path.rsplit(".", 1)[-1] for s in g.units[0].slices}
        assert leaves == {"router", "w_gate", "w_up", "w_down"}
    kinds = {g.kind for g in prunable(tgroups)}
    assert kinds >= {"expert", "expert_mlp", "heads"}


def _l1(arch):
    if ("l1", arch) not in _RESULTS:
        jm, jp, tm, tp = models(arch)
        _RESULTS[("l1", arch)] = (j_prune_model(jm, jp, 0.5, criterion="l1"),
                                  prune_model(tm, tp, 0.5, criterion="l1"))
    return _RESULTS[("l1", arch)]


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_l1_units_config_and_weights_match_jax(arch, monkeypatch):
    jm, jp, tm, tp = models(arch)
    jr, tr = _l1(arch)
    assert tr.pruned_units == jr.pruned_units
    assert tr.report["units_pruned"] == jr.report["units_pruned"]
    assert tr.cfg == convert.convert_config(dataclasses.asdict(jr.cfg))
    c = tr.cfg
    assert (c.n_experts, c.top_k, c.moe_d_ff) == (4, 2, 16)
    assert c.n_shared_experts * c.shared_d_ff == (64 if arch == "qwen2"
                                                  else 0)
    jleaves = dict(tree_paths(jax.tree.map(np.asarray, jr.params)))
    for path, leaf in tree_paths(tr.params):
        np.testing.assert_array_equal(leaf.numpy(), jleaves[path])
    held = sum(t.numel() for _, t in tree_paths(tr.params))
    assert c.param_count() == held
    toks = np.random.default_rng(0).integers(
        0, jm.cfg.vocab_size, size=(2, 21)).astype(np.int32)
    j_in = _captured_moe_inputs(monkeypatch, j_moe)
    t_in = _captured_moe_inputs(monkeypatch, t_moe)
    ref = np.asarray(j_build(jr.cfg).forward(
        jr.params, {"tokens": jnp.asarray(toks)}, unroll=True))
    with torch.no_grad():
        got = t_build(c).forward(tr.params, {"tokens": T(toks)})
    for i, (jx, tx) in enumerate(zip(j_in, t_in)):
        jl, tl = _layer_params(jr.params, tr.params, i)
        assert_same_routing(jl["router"], tl["router"], jx, tx, c.top_k,
                            what=f"pruned layer {i}")
    close(got, ref)


def _obspa():
    """(JAX model, JAX params, port model, port params, JAX calibration,
    port calibration, JAX result, port result) on reduced qwen2-moe."""
    if "obspa" not in _RESULTS:
        jm, jp, tm, tp = models("qwen2")
        jc = j_batches(jm.cfg, "id", 2, 4, 24, seed=1, with_targets=False)
        tc = batches(tm.cfg, "id", 2, 4, 24, seed=1, device="cpu")
        jr = j_obspa_prune(jm, jp, 0.5, jc, recalibrate=False)
        tr = obspa_prune(tm, tp, 0.5, tc)
        _RESULTS["obspa"] = (jm, jp, tm, tp, jc, tc, jr, tr)
    return _RESULTS["obspa"]


def test_obspa_consumers_match_jax(monkeypatch):
    """The calibration routes clear of ties in both packages (the Hessians
    of the experts depend on it); the same consumers as the reference's."""
    jm, jp, tm, tp, jc, tc, _, _ = _obspa()
    j_in = _captured_moe_inputs(monkeypatch, j_moe)
    t_in = _captured_moe_inputs(monkeypatch, t_moe)
    for a, b in zip(jc, tc):
        np.testing.assert_array_equal(np.asarray(a["tokens"]),
                                      b["tokens"].numpy())
        jm.forward(jp, a, unroll=True)
        with torch.no_grad():
            tm.forward(tp, b)
    for n, (jx, tx) in enumerate(zip(j_in, t_in)):
        jl, tl = _layer_params(jp, tp, n % tm.cfg.num_layers)
        assert_same_routing(jl["router"], tl["router"], jx, tx,
                            tm.cfg.top_k, what=f"calibration {n}")
    monkeypatch.undo()
    jg, jgroups, _ = j_analyze(jm, jp, batch=jc[0])
    ref = _consumer_table(j_find_consumers(jg, j_prunable(jgroups)))
    tg, _ = trace_model(tm, tp, batch=tc[0])
    got = _consumer_table(find_consumers(tg, prunable(group_graph(tm.cfg,
                                                                  tg))))
    assert got == ref
    for i in range(tm.cfg.num_layers):
        pre = f"layers.{i}.moe."
        assert got[(pre + "w_down", 1)] == [(pre + "w_down", (1,), (0,))]
        assert got[(pre + "shared.w_down", 0)] == [
            (pre + "shared.w_down", (0,), ())]
        assert got[(pre + "router", 1)] == []      # whole experts: none


def test_obspa_matches_jax():
    _, _, tm, _, _, _, jr, tr = _obspa()
    assert tr.report["groups_with_obs"] == jr.report["groups_with_obs"]
    assert tr.report["groups_total"] == jr.report["groups_total"]
    assert tr.pruned_units == jr.pruned_units
    assert tr.report["units_pruned"] == jr.report["units_pruned"]
    assert tr.cfg == convert.convert_config(dataclasses.asdict(jr.cfg))
    c = tr.cfg
    assert (c.n_experts, c.moe_d_ff, c.shared_d_ff) == (4, 16, 32)
    jleaves = dict(tree_paths(jax.tree.map(np.asarray, jr.params)))
    for path, leaf in tree_paths(tr.params):
        ref = jleaves[path]
        assert leaf.shape == ref.shape, path
        err = np.abs(leaf.numpy() - ref).max() / (np.abs(ref).max() + 1e-12)
        assert err < 1e-4, (path, err)


def test_obspa_sweeps_the_experts_in_one_batched_call(monkeypatch):
    """The experts' ``w_down`` goes through ``obspa_sweep_batched`` with the
    experts as its batch (K4's grid y on the card), one call per layer."""
    from repro_torch.core import obspa as t_obspa
    _, _, tm, tp, _, tc, _, _ = _obspa()
    calls = []
    real = t_obspa.obspa_sweep_batched

    def spy(w, h, mask):
        calls.append(tuple(w.shape))
        return real(w, h, mask)

    monkeypatch.setattr(t_obspa, "obspa_sweep_batched", spy)
    obspa_prune(tm, tp, 0.5, tc)
    cfg = tm.cfg
    assert calls.count((cfg.n_experts, cfg.d_model, cfg.moe_d_ff)) == \
        cfg.num_layers


def test_layer_output_errors_match_jax():
    """Every reconstructed consumer (experts and shared experts included),
    the port's reconstruction against the reference's, both as port
    tensors: the same plain-slicing error and the same ratio to it."""
    _, _, tm, tp, _, tc, jr, tr = _obspa()
    j_as_port = dataclasses.replace(
        tr, params=convert.convert_params(jax.tree.map(np.asarray,
                                                       jr.params)))
    t_err = layer_output_errors(tm, tp, tr, tc)
    j_err = layer_output_errors(tm, tp, j_as_port, tc)
    assert set(t_err) == set(j_err)
    assert len(t_err) == 3 * tm.cfg.num_layers
    assert sum(".moe.w_down@" in n for n in t_err) == tm.cfg.num_layers
    for name, (e_ob, e_cut) in t_err.items():
        j_ob, j_cut = j_err[name]
        assert j_cut == e_cut and e_cut > 0, name
        assert 0 <= e_ob < e_cut, name
        assert e_ob / e_cut == pytest.approx(j_ob / j_cut, rel=1e-3,
                                             abs=1e-6), name
