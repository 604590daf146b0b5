"""PyTorch port vs JAX reference: OBSPA on the cnn family — conv consumers
(``F.unfold`` patches at the consumer's own stride and padding), the
global selection of layer-OBS scores, the K4 sweep's reconstruction over
runs of kh·kw columns, and the BatchNorm re-estimation (paper App. B.3).

On converted weights (``test_torch_cnn.models``) and the same ``id``
calibration images: the consumers equal the reference's — every conv
(groups 1) reading a pruned group on its input channels, and ``fc`` — with
one Hessian a (map, convolution) pair; the unit scores each pruner used
agree to ``OBS_TOL`` of each group's largest, with the cut's gap above
twice that (``test_torch_cnn_prune.assert_same_selection``); then the
units, every inverse Hessian within 1e-4 of its largest entry, every
reconstructed weight within 1e-4 of its leaf's largest, and the
recalibrated running statistics within 1e-4 of each leaf's largest.
The mirrors of ``tests/test_obspa.py``'s CNN cases run on the port alone.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.core.obspa as j_obspa
import repro.models.cnn as j_cnn
from repro.data.synthetic import batches as j_batches
from repro.kernels.obspa_update.ref import sweep_reference
import repro_torch.core.obspa as t_obspa
from repro_torch.core.graph import tree_map_paths, tree_paths
from repro_torch.core.obspa import (_conv_geometry, hkey,
                                    layer_output_errors, obspa_prune)
from repro_torch.core.pruner import (apply_pruning, delete_positions,
                                     leaf_shapes, prune_model, to_analysis,
                                     trace_model)
from repro_torch.data.synthetic import batches
from repro_torch.models import build as t_build
from test_torch_cnn import ARCHS, models, one_thread  # noqa: F401
from test_torch_cnn_prune import assert_same_selection

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

OBS_TOL = 1e-4
RTOL = 1e-4
_RESULTS: dict = {}


def _keep(store: dict, name: str, monkeypatch, module, fn_name: str):
    real = getattr(module, fn_name)

    def keeping(*a, **kw):
        out = real(*a, **kw)
        store[name] = out
        return out
    monkeypatch.setattr(module, fn_name, keeping)


def case(arch, monkeypatch):
    """(JAX model, JAX params, port model, port params, JAX calibration,
    port calibration, JAX result, port result, what each pruner computed:
    consumers, inverse Hessians, unit scores)."""
    if arch not in _RESULTS:
        jm, jp, tm, tp = models(arch)
        jc = j_batches(jm.cfg, "id", 2, 8, 0, seed=1)
        tc = batches(tm.cfg, "id", 2, 8, 0, seed=1, device="cpu")
        # the reference's sweep through its plain jnp version (its Pallas
        # kernel in interpret mode compiles once per column block), and its
        # recalibration forward under jit: the same functions, faster here
        monkeypatch.setattr(j_obspa, "obspa_sweep", lambda w, h, m: (
            sweep_reference(jnp.asarray(w), jnp.asarray(h), jnp.asarray(m))))
        monkeypatch.setattr(j_cnn, "cnn_forward", jax.jit(
            j_cnn.cnn_forward, static_argnums=(0, 4)))
        js, ts = {}, {}
        for store, mod, fns in (
                (js, j_obspa, ("find_consumers", "accumulate_hessians",
                               "obs_unit_scores")),
                (ts, t_obspa, ("find_consumers", "invert_hessians",
                               "obs_unit_scores"))):
            for fn in fns:
                _keep(store, fn, monkeypatch, mod, fn)
        jr = j_obspa.obspa_prune(jm, jp, 0.5, jc, calib_mode="id")
        tr = obspa_prune(tm, tp, 0.5, tc, calib_mode="id")
        _RESULTS[arch] = (jm, jp, tm, tp, jc, tc, jr, tr, js, ts)
    return _RESULTS[arch]


def _table(consumers) -> dict:
    """(path, axis) -> sorted (param path, kind, contracted axes of a
    product consumer)."""
    return {key: sorted((c.param_path, c.kind,
                         tuple(c.param_contract) if c.kind == "dot" else ())
                        for c in cs)
            for key, cs in consumers.items()}


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_obspa_consumers_match_jax(arch, monkeypatch):
    """The consumers each package's ``obspa_prune`` found (captured from
    its ``find_consumers``) on the same calibration images."""
    _, _, _, _, jc, tc, _, _, js, ts = case(arch, monkeypatch)
    for a, b in zip(jc, tc):
        np.testing.assert_array_equal(np.asarray(a["images"]),
                                      b["images"].numpy())
    jcons, tcons = js["find_consumers"], ts["find_consumers"]
    assert _table(tcons) == _table(jcons)
    every = {c.op.uid: c for cs in tcons.values() for c in cs}
    kinds = {c.kind for c in every.values()}
    assert kinds == {"conv", "dot"}
    for c in every.values():
        if c.kind == "conv":
            assert c.param_contract == (2, 0, 1)
    # one Hessian a consumer op, as in the reference; the stride-2 block's
    # 3x3 conv1 and 1x1 projection read one map, keep two
    jkeys = {j_obspa.hkey(c) for cs in jcons.values() for c in cs}
    tkeys = {hkey(c) for c in every.values()}
    assert len(tkeys) == len(jkeys) == len(every)
    if arch == "resnet18":
        by = {c.param_path: c for c in every.values()}
        jby = {c.param_path: c for cs in jcons.values() for c in cs}
        a, b = "params.s1b0.conv1", "params.s1b0.proj"
        assert jby[a].x_uid == jby[b].x_uid      # the same map
        assert hkey(by[a]) != hkey(by[b])


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_obspa_matches_jax(arch, monkeypatch):
    """Scores, units, inverse Hessians, reconstructed weights and the
    recalibrated BatchNorm statistics."""
    jm, jp, tm, tp, jc, tc, jr, tr, js, ts = case(arch, monkeypatch)
    assert tr.report["mode"] == jr.report["mode"] == "global"
    assert tr.report["groups_with_obs"] == jr.report["groups_with_obs"]
    assert "recalibrate" in tr.report["seconds"]
    ap = to_analysis(tm.cfg, tp)
    assert_same_selection(js["obs_unit_scores"][0],
                          ts["obs_unit_scores"][0], tr.groups,
                          leaf_shapes(ap), 0.5, "obspa", tol=OBS_TOL)
    assert tr.pruned_units == jr.pruned_units
    assert tr.cfg == tm.cfg
    # inverse Hessians, matched by their consumer's weight (one each)
    jhinv = {c.param_path: js["accumulate_hessians"][j_obspa.hkey(c)]
             for cs in js["find_consumers"].values() for c in cs}
    thinv = {c.param_path: ts["invert_hessians"][hkey(c)]
             for cs in ts["find_consumers"].values() for c in cs}
    assert thinv.keys() == jhinv.keys()
    for path, ref in jhinv.items():
        np.testing.assert_allclose(thinv[path].numpy(), ref, rtol=0,
                                   atol=RTOL * np.abs(ref).max(),
                                   err_msg=path)
    ref = dict(tree_paths(jax.tree.map(np.asarray, jr.params)))
    got = dict(tree_paths(tr.params))
    assert got.keys() == ref.keys()
    for path in ref:
        assert got[path].shape == ref[path].shape, path
        np.testing.assert_allclose(got[path].numpy(), ref[path], rtol=0,
                                   atol=RTOL * np.abs(ref[path]).max(),
                                   err_msg=path)
    # the sweep changed the kept columns of every conv consumer it swept
    dense = dict(tree_paths(ap))
    sliced = dict(tree_paths(apply_pruning(
        ap, delete_positions(tr.groups, tr.pruned_units))))
    moved = [p for p in thinv if p.endswith("conv2") or p.endswith(".conv")
             if not torch.equal(got[p], sliced[p])]
    assert moved and dense


def _logit_mse(m, p, m2, p2, evalb):
    with torch.no_grad():
        return float(((m.forward(p, evalb) - m2.forward(p2, evalb)) ** 2)
                     .mean())


def _reference_init():
    """The reference test's model: reduced resnet18-cifar as the JAX
    package's ``init`` draws it at ``PRNGKey(0)`` — the weights of
    ``models("resnet18")`` with the BatchNorm leaves at their init (scale
    1, bias 0, mean 0, var 1) instead of redrawn."""
    _, _, tm, tp = models("resnet18")
    init = {"scale": 1.0, "bias": 0.0, "mean": 0.0, "var": 1.0}
    return tm, tree_map_paths(
        lambda path, x: torch.full_like(x, init[path.rsplit(".", 1)[1]])
        if x.ndim == 1 else x.clone(), tp)


def test_reconstruction_beats_naive():
    """``tests/test_obspa.py::test_reconstruction_beats_naive
    [resnet18-cifar]`` on the port: OBSPA (no recalibration) leaves the
    logits closer to the dense model's than magnitude pruning."""
    m, params = _reference_init()
    calib = batches(m.cfg, "id", 4, 8, 16, seed=1, device="cpu")
    evalb = batches(m.cfg, "id", 1, 8, 16, seed=99, device="cpu")[0]
    naive = prune_model(m, params, 0.5, criterion="l1")
    ob = obspa_prune(m, params, 0.5, calib, recalibrate=False)
    e_naive = _logit_mse(m, params, t_build(naive.cfg), naive.params, evalb)
    e_ob = _logit_mse(m, params, t_build(ob.cfg), ob.params, evalb)
    assert e_ob < e_naive, (e_ob, e_naive)


def test_bn_recalibration_changes_stats():
    """``tests/test_obspa.py::test_bn_recalibration_changes_stats`` on the
    port, and DataFree calibration leaves the statistics as sliced."""
    m, params = _reference_init()
    calib = batches(m.cfg, "id", 3, 8, 0, seed=1, device="cpu")
    res_no = obspa_prune(m, params, 0.4, calib, recalibrate=False)
    res_yes = obspa_prune(m, params, 0.4, calib, recalibrate=True,
                          calib_mode="id")
    flat = lambda r: torch.cat([x.reshape(-1) for _, x in  # noqa: E731
                                tree_paths(r.params["state"])])
    assert not torch.allclose(flat(res_no), flat(res_yes))
    assert "recalibrate" not in res_no.report["seconds"]
    free = batches(m.cfg, "datafree", 2, 8, 0, seed=1, device="cpu")
    res_free = obspa_prune(m, params, 0.4, free, calib_mode="datafree")
    assert "recalibrate" not in res_free.report["seconds"]
    sliced = apply_pruning(params, delete_positions(res_free.groups,
                                                    res_free.pruned_units))
    for (p, a), (_, b) in zip(tree_paths(res_free.params["state"]),
                              tree_paths(sliced["state"])):
        assert torch.equal(a, b), p
    with torch.no_grad():
        logits = t_build(res_free.cfg).forward(res_free.params, free[0])
    assert bool(torch.isfinite(logits).all())


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_layer_output_errors_through_the_conv_view(arch, monkeypatch):
    """``layer_output_errors`` reads every swept conv and fc consumer
    through its (C_out, C_in·kh·kw) view: one entry each, finite and
    positive, and plain slicing's error of a conv equals ‖conv(X, ΔW)‖²
    over the calibration maps, ΔW the weights of its cut input channels
    and of its own cut output channels."""
    _, _, tm, tp, _, tc, _, tr, _, ts = case(arch, monkeypatch)
    errs = layer_output_errors(tm, tp, tr, tc)
    swept = {c.param_path for cs in ts["find_consumers"].values()
             for c in cs}
    assert {k.split("@")[0] for k in errs} == swept
    for e_ob, e_cut in errs.values():
        assert 0 < e_ob < float("inf") and 0 < e_cut < float("inf")
    # slicing's error of one conv consumer, by hand
    name = [k for k in errs if k.startswith("params.s1")][0]
    path = name.split("@")[0]
    c = [c for cs in ts["find_consumers"].values() for c in cs
         if c.param_path == path][0]
    dele = delete_positions(tr.groups, tr.pruned_units)
    g, ap = trace_model(tm, tp, batch=tc[0])
    w = dict(tree_paths(ap))[path]
    cut = [torch.zeros(w.shape[a], dtype=torch.bool) for a in (2, 3)]
    for (p, a), pos in dele.items():
        if p == path:
            cut[a - 2][sorted(pos)] = True
    assert cut[0].any()
    delta = w * (cut[0][:, None] | cut[1][None, :])
    total = 0.0
    for b in tc:
        _, cap = g.evaluate(dict(tree_paths(ap)),
                            [t for _, t in tree_paths(b)],
                            capture={c.x_uid})
        x = cap[c.x_uid]
        geo = _conv_geometry(c.op)
        y = torch.nn.functional.conv2d(x, delta.permute(3, 2, 0, 1),
                                       stride=geo["stride"],
                                       padding=geo["padding"])
        total += float((y.double() ** 2).sum())
    assert errs[name][1] == pytest.approx(total, rel=1e-4)
