"""PyTorch port vs JAX reference: OBSPA on the SSM consumers (reduced
Mamba-2 and reduced Hymba).

On converted weights and the same calibration batches (numpy-drawn, token
for token the same), the port's ``find_consumers`` on its ATen graph must
return the consumers the reference's finds on its jaxpr (parameter paths,
contracted and batch axes): ``ssm.w_out`` over the SSM heads and over
head_dim, and for the hybrid also ``attn.wo`` and ``mlp.w_down``; the SSM
state group has none (``B`` meets ``C`` inside the scan), so both packages
score it by magnitude.  ``obspa_prune`` must then score the same groups by
OBS, prune the same units, read back the same config and reconstruct the
same weights within 1e-4 relative (the sweep's tolerance; Hessians differ
in f32 summation order), and every consumer's layer-output error must stand
at the same ratio to plain slicing as the reference's reconstruction leaves
it (1e-3).  Hymba's calibration sequences (40) are longer than its window
(32).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax

from repro.configs import get_config as j_get_config, reduced as j_reduced
from repro.core.obspa import find_consumers as j_find_consumers
from repro.core.obspa import obspa_prune as j_obspa_prune
from repro.core.pruner import analyze as j_analyze, prunable as j_prunable
from repro.data.synthetic import batches as j_batches
from repro.models import build as j_build
from repro_torch import convert
from repro_torch.core.graph import tree_paths
from repro_torch.core.groups import build_groups
from repro_torch.core.obspa import (find_consumers, layer_output_errors,
                                    obspa_prune)
from repro_torch.core.pruner import prunable, trace_model
from repro_torch.data.synthetic import batches
from repro_torch.models import build

torch.backends.cuda.matmul.allow_tf32 = False

ARCHS = {"mamba2": ("mamba2-1.3b", 16), "hymba": ("hymba-1.5b", 40)}
_CASES: dict = {}


@pytest.fixture(autouse=True)
def one_thread():
    """Many small products: one intra-op thread under the test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def case(arch: str):
    """(JAX model, JAX params, port model, port params, JAX calibration,
    port calibration, JAX result, port result) at ratio 0.5."""
    if arch not in _CASES:
        name, seq = ARCHS[arch]
        jcfg = j_reduced(j_get_config(name))
        jm = j_build(jcfg)
        jp = jax.jit(jm.init)(jax.random.PRNGKey(0))    # quicker than eager
        tcfg = convert.convert_config(dataclasses.asdict(jcfg))
        tm = build(tcfg)
        tp = convert.convert_params(jax.tree.map(np.asarray, jp))
        jc = j_batches(jcfg, "id", 2, 4, seq, seed=1, with_targets=False)
        tc = batches(tcfg, "id", 2, 4, seq, seed=1, device="cpu")
        jr = j_obspa_prune(jm, jp, 0.5, jc, recalibrate=False)
        tr = obspa_prune(tm, tp, 0.5, tc)
        _CASES[arch] = (jm, jp, tm, tp, jc, tc, jr, tr)
    return _CASES[arch]


def _consumer_table(consumers):
    """(path, axis) -> sorted (param path, contracted axes, batch axes)."""
    return {key: sorted((c.param_path, tuple(c.param_contract),
                         tuple(c.param_batch)) for c in cs)
            for key, cs in consumers.items()}


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_consumers_match_jax(arch):
    jm, jp, tm, tp, jc, tc, _, _ = case(arch)
    for a, b in zip(jc, tc):
        np.testing.assert_array_equal(np.asarray(a["tokens"]),
                                      b["tokens"].numpy())
    jg, jgroups, _ = j_analyze(jm, jp, batch=jc[0])
    ref = _consumer_table(j_find_consumers(jg, j_prunable(jgroups)))
    tg, _ = trace_model(tm, tp, batch=tc[0])
    got = _consumer_table(find_consumers(tg, prunable(build_groups(tg))))
    assert got == ref
    with_consumers = {".".join(p.split(".")[2:])
                      for (p, _), cs in got.items() if cs}
    expect = {"ssm.w_out"} | ({"attn.wo", "mlp.w_down"}
                              if tm.cfg.hybrid else set())
    assert with_consumers == expect
    for i in range(tm.cfg.num_layers):
        assert got[(f"layers.{i}.ssm.w_out", 0)] == [
            (f"layers.{i}.ssm.w_out", (0, 1), ())]
        assert got[(f"layers.{i}.ssm.w_B", 1)] == []


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_obspa_matches_jax(arch):
    _, _, tm, _, _, _, jr, tr = case(arch)
    assert tr.report["groups_with_obs"] == jr.report["groups_with_obs"]
    assert tr.report["groups_total"] == jr.report["groups_total"]
    assert tr.pruned_units == jr.pruned_units
    assert tr.report["units_pruned"] == jr.report["units_pruned"]
    assert tr.cfg == convert.convert_config(dataclasses.asdict(jr.cfg))
    c = tr.cfg
    assert (c.ssm_n_heads, c.ssm_head_dim, c.ssm_state) == (4, 8, 8)
    if c.hybrid:
        assert (c.n_heads, c.v_head_dim_, c.d_ff) == (2, 8, 64)
    jleaves = dict(tree_paths(jax.tree.map(np.asarray, jr.params)))
    for path, leaf in tree_paths(tr.params):
        ref = jleaves[path]
        assert leaf.shape == ref.shape, path
        err = np.abs(leaf.numpy() - ref).max() / (np.abs(ref).max() + 1e-12)
        assert err < 1e-4, (path, err)
    evalb = batches(tm.cfg, "id", 1, 2, 37, seed=9, device="cpu")[0]
    with torch.no_grad():
        out = build(tr.cfg).forward(tr.params, evalb)
    assert torch.isfinite(out).all()


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_layer_output_errors_match_jax(arch):
    """Every reconstructed consumer (SSM ones included), the port's
    reconstruction against the reference's, both as port tensors: the same
    plain-slicing error and the same ratio to it."""
    _, _, tm, tp, _, tc, jr, tr = case(arch)
    j_as_port = dataclasses.replace(
        tr, params=convert.convert_params(jax.tree.map(np.asarray,
                                                       jr.params)))
    t_err = layer_output_errors(tm, tp, tr, tc)
    j_err = layer_output_errors(tm, tp, j_as_port, tc)
    per_layer = 3 if tm.cfg.hybrid else 1
    assert set(t_err) == set(j_err)
    assert len(t_err) == per_layer * tm.cfg.num_layers
    assert sum(".ssm.w_out@" in n for n in t_err) == tm.cfg.num_layers
    for name, (e_ob, e_cut) in t_err.items():
        j_ob, j_cut = j_err[name]
        assert j_cut == e_cut and e_cut > 0, name
        assert e_ob >= 0
        assert e_ob / e_cut == pytest.approx(j_ob / j_cut, rel=1e-3,
                                             abs=1e-6), name
        print(f"{arch} {name}: error / slicing {e_ob / e_cut:.4f} (JAX "
              f"{j_ob / j_cut:.4f})")
