"""PyTorch port vs JAX reference: OBSPA on the audio and vlm families —
layer-OBS scores, the column sweep's reconstruction of ``attn.wo`` and
``mlp.w_down``, with calibration from frames (ID, OOD, DataFree) or from
patches and tokens (DataFree, paligemma's only regime at full width).

On converted weights (``test_torch_encoder.models``) and the same
calibration batches: the same consumers, the OBS unit scores within 1e-4
of each group's largest with every group's cut more than twice that apart
(``test_torch_encoder_prune.assert_same_cuts``), the same units and
config, weights within 1e-4 of each leaf's largest value, and every
consumer's layer-output error at the same ratio to plain slicing as the
reference's reconstruction leaves it (1e-3).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.core.obspa as j_obspa
from repro.core.obspa import find_consumers as j_find_consumers
from repro.core.pruner import analyze as j_analyze
from repro.core.pruner import prunable as j_prunable
from repro.data.synthetic import batches as j_batches
from repro.kernels.obspa_update.ref import sweep_reference
from repro_torch import convert
import repro_torch.core.obspa as t_obspa
from repro_torch.core.graph import tree_paths
from repro_torch.core.obspa import (find_consumers, layer_output_errors,
                                    obspa_prune)
from repro_torch.core.pruner import analyze, prunable, trace_model
from repro_torch.data.synthetic import batches
from test_torch_encoder import T, models
from test_torch_encoder_prune import _capture, assert_same_cuts, seq_of
from test_torch_obspa_ssm import _consumer_table

torch.backends.cuda.matmul.allow_tf32 = False

OBS_TOL = 1e-4
RTOL = 1e-4
_RESULTS: dict = {}


# each calibration regime once, each family at least once (paligemma's ID
# and OOD batches cannot be built at full width: DataFree is its card path)
OBSPA_CASES = [("hubert", "id"), ("hubert", "datafree"), ("vit", "ood"),
               ("paligemma-3b", "datafree")]


def _obspa(arch, mode, monkeypatch):
    if ("obspa", arch, mode) not in _RESULTS:
        jm, jp, tm, tp = models(arch)
        seq = seq_of(jm.cfg)
        jc = j_batches(jm.cfg, mode, 2, 4, seq, seed=1)
        tc = batches(tm.cfg, mode, 2, 4, seq, seed=1, device="cpu")
        # the reference's sweep through its plain jnp version (its Pallas
        # kernel in interpret mode compiles once per column block)
        monkeypatch.setattr(j_obspa, "obspa_sweep", lambda w, h, m: (
            sweep_reference(jnp.asarray(w), jnp.asarray(h), jnp.asarray(m))))
        js, ts = [], []
        _capture(monkeypatch, j_obspa, "obs_unit_scores", js)
        _capture(monkeypatch, t_obspa, "obs_unit_scores", ts)
        jr = j_obspa.obspa_prune(jm, jp, 0.5, jc, calib_mode=mode)
        tr = obspa_prune(tm, tp, 0.5, tc, calib_mode=mode)
        _RESULTS[("obspa", arch, mode)] = (jc, tc, jr, tr, js[0][0],
                                           ts[0][0])
    return _RESULTS[("obspa", arch, mode)]


@pytest.mark.parametrize("arch,mode", OBSPA_CASES)
def test_obspa_matches_jax(arch, mode, monkeypatch):
    """Calibration from frames, or patches and tokens; layer-OBS scores
    past the cut's gap; units, config and reconstructed weights; every
    consumer's layer-output error over plain slicing's as the
    reference's."""
    jm, jp, tm, tp = models(arch)
    jc, tc, jr, tr, js, ts = _obspa(arch, mode, monkeypatch)
    for a, b in zip(jc, tc):
        for k in b:
            np.testing.assert_array_equal(b[k].numpy(), np.asarray(a[k]))
    assert tr.report["groups_with_obs"] == jr.report["groups_with_obs"] \
        == len(tr.groups)
    assert_same_cuts(js, ts, tr.groups, 0.5, f"obspa {mode}", OBS_TOL)
    assert tr.pruned_units == jr.pruned_units
    assert tr.cfg == convert.convert_config(dataclasses.asdict(jr.cfg))
    jleaves = dict(tree_paths(jax.tree.map(np.asarray, jr.params)))
    for path, leaf in tree_paths(tr.params):
        ref = jleaves[path]
        assert leaf.shape == ref.shape, path
        err = np.abs(leaf.numpy() - ref).max() / (np.abs(ref).max() + 1e-12)
        assert err < RTOL, (path, err)
    j_as_port = dataclasses.replace(
        tr, params=convert.convert_params(jax.tree.map(np.asarray,
                                                       jr.params)))
    t_err = layer_output_errors(tm, tp, tr, tc)
    j_err = layer_output_errors(tm, tp, j_as_port, tc)
    assert set(t_err) == set(j_err)
    assert len(t_err) == 2 * tm.cfg.num_layers
    for name, (e_ob, e_cut) in t_err.items():
        j_ob, j_cut = j_err[name]
        assert j_cut == e_cut and e_cut > 0, name
        assert e_ob / e_cut == pytest.approx(j_ob / j_cut, rel=1e-3,
                                             abs=1e-6), name


@pytest.mark.parametrize("arch", ["hubert", "paligemma-3b"])
def test_obspa_consumers_match_jax(arch):
    """``attn.wo`` and ``mlp.w_down`` of every layer, as the reference finds
    them on the same calibration batch; not the front ends or the head
    (their contracted axes are never pruned)."""
    jm, jp, tm, tp = models(arch)
    jb = j_batches(jm.cfg, "datafree", 1, 2, seq_of(jm.cfg), seed=3)[0]
    jg, jgroups, _ = j_analyze(jm, jp, batch=jb)
    ref = _consumer_table(j_find_consumers(jg, j_prunable(jgroups)))
    tg, _ = trace_model(tm, tp, batch=T(jb))
    _, tgroups, _ = analyze(tm, tp)
    got = _consumer_table(find_consumers(tg, prunable(tgroups)))
    assert got == ref
    leaves = {p.split(".", 2)[-1] for cs in got.values() for p, *_ in cs}
    assert leaves == {"attn.wo", "mlp.w_down"}
