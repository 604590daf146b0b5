"""PyTorch port vs JAX reference: SPA analysis and magnitude pruning.

Both packages analyse the same converted weights: group keys, kinds, unit
counts, protection and every unit's parameter slices must be identical
(reduced tinyllama, qwen3-1.7b with qk-norm, and tinyllama with two KV
heads, whose whole-KV-group cover reduced tinyllama's single KV head leaves
untested).  ``prune_model`` (l1, l2) must prune the same units, infer the
same config and give logits within 1e-5 of the JAX-pruned model (f32).
The port-pruned model is then served by the engine and held token for token
against the sequential ``generate`` oracle, and the CLI prunes on the CPU.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as j_get_config, reduced as j_reduced
from repro.core.pruner import analyze as j_analyze
from repro.core.pruner import prune_model as j_prune_model
from repro.core.pruner import select_units as j_select_units
from repro.models import build as j_build
from repro_torch import convert
from repro_torch.core.graph import tree_paths
from repro_torch.core.importance import leaf_scores, unit_scores
from repro_torch.core.pruner import (analyze, prunable, prune_model,
                                     select_units)
from repro_torch.launch.serve import generate
from repro_torch.models import build as t_build
from repro_torch.serve import Engine, ServeConfig

torch.backends.cuda.matmul.allow_tf32 = False

ATOL = 1e-5
CONFIGS = {
    "tinyllama": ("tinyllama-1.1b", {}),
    "qwen3-qknorm": ("qwen3-1.7b", {}),
    "tinyllama-kv2": ("tinyllama-1.1b", {"n_kv_heads": 2}),
}
_MODELS: dict = {}


def models(case: str):
    """(JAX model, JAX params, port model, port params) on shared weights."""
    if case not in _MODELS:
        name, kw = CONFIGS[case]
        jcfg = j_reduced(j_get_config(name)).replace(**kw)
        jm = j_build(jcfg)
        jp = jm.init(jax.random.PRNGKey(0))
        tm = t_build(convert.convert_config(dataclasses.asdict(jcfg)))
        tp = convert.convert_params(jax.tree.map(np.asarray, jp))
        _MODELS[case] = (jm, jp, tm, tp)
    return _MODELS[case]


def summary(groups):
    return {gr.key: (gr.kind, gr.n_units, gr.protected, gr.reason,
                     [[(s.path, s.axis, tuple(s.positions))
                       for s in u.slices] for u in gr.units])
            for gr in groups}


@pytest.mark.parametrize("case", sorted(CONFIGS))
def test_groups_identical_to_jax(case):
    jm, jp, tm, tp = models(case)
    _, jgroups, _ = j_analyze(jm, jp)
    _, tgroups, _ = analyze(tm, tp)
    assert summary(tgroups) == summary(jgroups)
    kinds = {gr.kind for gr in prunable(tgroups)}
    assert kinds == {"heads", "mlp"}
    if tm.cfg.n_kv_heads >= 2:
        # whole-KV-group cover: one unit = one KV head and its G query heads
        kv = [gr for gr in tgroups if gr.key == "layers.0.attn.wk:1"][0]
        G = tm.cfg.n_heads // tm.cfg.n_kv_heads
        assert not kv.protected and kv.n_units == tm.cfg.n_kv_heads
        wq = [s for s in kv.units[1].slices if s.path == "layers.0.attn.wq"]
        assert wq[0].positions == tuple(range(G, 2 * G))


@pytest.mark.parametrize("criterion", ["l1", "l2"])
@pytest.mark.parametrize("case", ["tinyllama", "tinyllama-kv2"])
def test_prune_model_matches_jax(case, criterion):
    jm, jp, tm, tp = models(case)
    jr = j_prune_model(jm, jp, 0.5, criterion=criterion)
    tr = prune_model(tm, tp, 0.5, criterion=criterion)
    assert tr.pruned_units == jr.pruned_units
    assert tr.report["units_pruned"] == jr.report["units_pruned"]
    assert tr.cfg == convert.convert_config(dataclasses.asdict(jr.cfg))
    jleaves = dict(tree_paths(jax.tree.map(np.asarray, jr.params)))
    for path, leaf in tree_paths(tr.params):
        np.testing.assert_array_equal(leaf.numpy(), jleaves[path])
    toks = np.random.default_rng(0).integers(
        0, jm.cfg.vocab_size, size=(2, 12)).astype(np.int32)
    ref = np.asarray(j_build(jr.cfg).forward(jr.params,
                                             {"tokens": jnp.asarray(toks)}))
    with torch.no_grad():
        got = t_build(tr.cfg).forward(tr.params,
                                      {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("align,mesh", [(2, 0), (3, 0), (1, 4), (2, 8)])
def test_select_units_alignment_matches_jax(align, mesh):
    """``align_units`` and ``mesh_divisor`` round every group's kept unit
    count as the reference does, on identical groups and scores."""
    jm, jp, tm, tp = models("tinyllama-kv2")
    _, jgroups, _ = j_analyze(jm, jp)
    _, tgroups, _ = analyze(tm, tp)
    jt = [gr for gr in jgroups if not gr.protected]
    tt = prunable(tgroups)
    rng = np.random.default_rng(10 * align + mesh)
    scores = {gr.key: rng.random(gr.n_units) for gr in tt}
    got = select_units(tt, scores, 0.5, align_units=align,
                       mesh_divisor=mesh)
    assert got == j_select_units(jt, scores, 0.5, align_units=align,
                                 mesh_divisor=mesh)
    plain = select_units(tt, scores, 0.5)
    assert any(len(got[k]) != len(plain[k]) for k in got)


def test_random_criterion_is_seeded_uniform():
    """``random`` cannot match JAX's PRNG bits; it is a seeded U[0, 1)."""
    _, _, tm, tp = models("tinyllama")
    a = leaf_scores(tp, "random", seed=3)
    b = leaf_scores(tp, "random", seed=3)
    c = leaf_scores(tp, "random", seed=4)
    va = torch.cat([t.reshape(-1) for _, t in tree_paths(a)])
    vb = torch.cat([t.reshape(-1) for _, t in tree_paths(b)])
    vc = torch.cat([t.reshape(-1) for _, t in tree_paths(c)])
    assert torch.equal(va, vb) and not torch.equal(va, vc)
    assert float(va.min()) >= 0.0 and float(va.max()) < 1.0
    assert abs(float(va.mean()) - 0.5) < 0.01
    assert abs(float(va.var()) - 1.0 / 12) < 0.005
    for (pa, ta), (_, tl) in zip(tree_paths(a), tree_paths(tp)):
        assert ta.shape == tl.shape and ta.dtype == torch.float32
    _, groups, ap = analyze(tm, tp)
    scores = unit_scores(prunable(groups), leaf_scores(ap, "random"))
    pr = prune_model(tm, tp, 0.5, criterion="random", seed=1)
    assert all(len(v) == gr.n_units // 2 for gr in pr.groups
               for k, v in pr.pruned_units.items() if k == gr.key)
    assert set(scores) == set(pr.pruned_units)


@pytest.mark.parametrize("criterion", ["snip", "grasp", "crop"])
def test_gradient_criteria_name_their_roadmap_item(criterion):
    _, _, tm, tp = models("tinyllama")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        prune_model(tm, tp, 0.5, criterion=criterion)


def test_engine_serves_the_port_pruned_model_like_the_oracle():
    _, _, tm, tp = models("tinyllama-kv2")
    pr = prune_model(tm, tp, 0.5, criterion="l1")
    pm = t_build(pr.cfg)
    assert pr.cfg.v_head_dim_ != pr.cfg.head_dim_          # D != DV
    prompt = np.random.default_rng(21).integers(
        0, pr.cfg.vocab_size, size=(3, 10))
    ref = generate(pm, pr.params, torch.from_numpy(prompt), 6).numpy()
    eng = Engine(pm, pr.params, ServeConfig(max_seqs=2, block_size=4,
                                            max_len=24, chunk_size=4),
                 device="cpu")
    rids = [eng.add_request([int(t) for t in row], max_new_tokens=6)
            for row in prompt]
    out, _ = eng.run()
    for b, rid in enumerate(rids):
        assert out[rid].tokens == list(ref[b, 10:])


@pytest.mark.parametrize("obspa", [False, True])
def test_cli_prunes_then_serves_on_the_cpu(obspa, capsys):
    from repro_torch.launch import serve as cli
    argv = ["--arch", "tinyllama-1.1b", "--reduced", "--requests", "3",
            "--prompt-len", "12", "--gen", "3", "--max-seqs", "2",
            "--block-size", "4", "--chunk-size", "8", "--prune-ratio",
            "0.5", "--device", "cpu"] + (["--obspa"] if obspa else [])
    cli.main(argv)
    out = capsys.readouterr().out
    assert "serving pruned model: tinyllama-1.1b-reduced-pruned" in out
    assert "served 3 requests / 9 new tokens" in out


def test_cli_prune_without_a_device_raises_here():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch.launch import serve as cli
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--arch", "tinyllama-1.1b", "--reduced", "--prune-ratio",
                  "0.5", "--obspa"])
