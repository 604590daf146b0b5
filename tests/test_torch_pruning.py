"""PyTorch port vs JAX reference: SPA analysis and magnitude pruning.

Both packages analyse the same converted weights: group keys, kinds, unit
counts, protection and every unit's parameter slices must be identical
(reduced tinyllama, qwen3-1.7b with qk-norm, tinyllama with two KV
heads, whose whole-KV-group cover reduced tinyllama's single KV head leaves
untested, and mamba2-1.3b, whose SSD block brings the pad, cumsum and
depthwise-convolution rules).  ``prune_model`` (l1, l2) must prune the same units, infer the
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
                                     select_units, trace_model)
from repro_torch.launch.serve import generate
from repro_torch.models import build as t_build
from repro_torch.serve import Engine, ServeConfig

torch.backends.cuda.matmul.allow_tf32 = False

ATOL = 1e-5
CONFIGS = {
    "tinyllama": ("tinyllama-1.1b", {}),
    "qwen3-qknorm": ("qwen3-1.7b", {}),
    "tinyllama-kv2": ("tinyllama-1.1b", {"n_kv_heads": 2}),
    "mamba2": ("mamba2-1.3b", {}),
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
    assert kinds == ({"ssm_heads", "ssm_state"} if tm.cfg.family == "ssm"
                     else {"heads", "mlp"})
    if tm.cfg.n_kv_heads >= 2:
        # whole-KV-group cover: one unit = one KV head and its G query heads
        kv = [gr for gr in tgroups if gr.key == "layers.0.attn.wk:1"][0]
        G = tm.cfg.n_heads // tm.cfg.n_kv_heads
        assert not kv.protected and kv.n_units == tm.cfg.n_kv_heads
        wq = [s for s in kv.units[1].slices if s.path == "layers.0.attn.wq"]
        assert wq[0].positions == tuple(range(G, 2 * G))


@pytest.mark.parametrize("criterion", ["l1", "l2"])
@pytest.mark.parametrize("case", ["tinyllama", "tinyllama-kv2", "mamba2"])
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
    va = torch.cat([t.reshape(-1) for t in a.values()])
    vb = torch.cat([t.reshape(-1) for t in b.values()])
    vc = torch.cat([t.reshape(-1) for t in c.values()])
    assert torch.equal(va, vb) and not torch.equal(va, vc)
    assert float(va.min()) >= 0.0 and float(va.max()) < 1.0
    assert abs(float(va.mean()) - 0.5) < 0.01
    assert abs(float(va.var()) - 1.0 / 12) < 0.005
    for (pa, ta), (_, tl) in zip(a.items(), tree_paths(tp)):
        assert ta.shape == tl.shape and ta.dtype == torch.float32
    _, groups, ap = analyze(tm, tp)
    scores = unit_scores(prunable(groups), leaf_scores(ap, "random"))
    pr = prune_model(tm, tp, 0.5, criterion="random", seed=1)
    assert all(len(v) == gr.n_units // 2 for gr in pr.groups
               for k, v in pr.pruned_units.items() if k == gr.key)
    assert set(scores) == set(pr.pruned_units)


@pytest.mark.parametrize("criterion", ["snip", "grasp", "crop"])
def test_gradient_criteria_name_their_roadmap_item(criterion):
    """The gradient criteria are ported (ROADMAP.md Queue 1 item 5); like
    the reference's, they need the batch their gradient is taken on."""
    _, _, tm, tp = models("tinyllama")
    with pytest.raises(ValueError, match="needs a grads batch"):
        prune_model(tm, tp, 0.5, criterion=criterion)


@pytest.mark.parametrize("criterion", ["snip", "grasp", "crop"])
@pytest.mark.parametrize("case", ["tinyllama", "tinyllama-kv2"])
def test_gradient_criteria_match_jax(case, criterion):
    """SNIP |g·θ|, GraSP -θ·Hg and CroP |θ·Hg| on the same grads batch:
    per-weight scores within 1e-4 of each leaf's largest score (g and Hg
    agree to summation order; Hg comes from a jvp over the gradient in both
    packages), and the same pruned units, config and weights."""
    jm, jp, tm, tp = models(case)
    toks = np.random.default_rng(21).integers(
        0, jm.cfg.vocab_size, size=(4, 24)).astype(np.int32)
    jr = j_prune_model(jm, jp, 0.5, criterion=criterion,
                       grads_batch={"tokens": jnp.asarray(toks)})
    tr = prune_model(tm, tp, 0.5, criterion=criterion,
                     grads_batch={"tokens": torch.from_numpy(toks)})
    assert tr.pruned_units == jr.pruned_units
    assert tr.cfg == convert.convert_config(dataclasses.asdict(jr.cfg))
    jleaves = dict(tree_paths(jax.tree.map(np.asarray, jr.params)))
    for path, leaf in tree_paths(tr.params):
        np.testing.assert_array_equal(leaf.numpy(), jleaves[path])
    # the scores themselves, on the analysis-form parameters
    from repro.core.importance import hessian_grad_product as j_hgp
    from repro.core.importance import leaf_scores as j_leaf_scores
    from repro.core.pruner import analyze as j_an
    from repro_torch.core.importance import hessian_grad_product
    _, _, jap = j_an(jm, jp)
    _, _, tap = analyze(tm, tp)
    jloss = lambda p: jm.loss(p, {"tokens": jnp.asarray(toks)},  # noqa
                              unroll=True)[0]
    tloss = lambda p: tm.loss(p, {"tokens": torch.from_numpy(toks)})[0]  # noqa
    if criterion == "snip":
        jg, jh = jax.grad(jloss)(jap), None
        tg, th = torch.func.grad(tloss)(tap), None
    else:
        jg, jh = j_hgp(jloss, jap)
        tg, th = hessian_grad_product(tloss, tap)
    want = dict(tree_paths(jax.tree.map(np.asarray, j_leaf_scores(
        jap, criterion, grads=jg, hg=jh))))
    for path, sc in leaf_scores(tap, criterion, grads=tg, hg=th).items():
        w = want[path]
        np.testing.assert_allclose(sc.numpy(), w, rtol=0,
                                   atol=1e-4 * float(np.abs(w).max()),
                                   err_msg=path)


def test_pruned_dense_param_count_is_the_tensors():
    """The analytic count of a pruned dense config (V head dim narrowed on
    its own) equals the parameters its tensors hold; the reference's
    formula counts v and o at head_dim."""
    _, _, tm, tp = models("tinyllama-kv2")
    pr = prune_model(tm, tp, 0.5, criterion="l1")
    assert pr.cfg.v_head_dim_ < pr.cfg.head_dim_
    held = sum(t.numel() for _, t in tree_paths(pr.params))
    assert pr.cfg.param_count() == held
    assert tm.cfg.param_count() == sum(t.numel()
                                       for _, t in tree_paths(tp))


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


def test_mamba2_groups_and_pruned_shapes():
    """Per layer: SSM heads (8 units: w_x/w_z/w_dt axis 1, w_out axis 0,
    A_log/D/dt_bias, 16 conv and 16 norm channels each), head_dim (16
    units) and state (16 units: w_B and w_C together, one B and one C conv
    channel each); at ratio 0.5 the config reads back 4 heads of head_dim 8
    and state 8, and d_model (the residual) is kept."""
    _, _, tm, tp = models("mamba2")
    _, groups, _ = analyze(tm, tp)
    got = {gr.key: (gr.kind, gr.n_units) for gr in prunable(groups)}
    for i in range(tm.cfg.num_layers):
        pre = f"layers.{i}.ssm."
        assert got[pre + "A_log:0"] == ("ssm_heads", 8)
        assert got[pre + "w_out:1"] == ("ssm_heads", 16)
        assert got[pre + "w_B:1"] == ("ssm_state", 16)
    assert len(got) == 3 * tm.cfg.num_layers
    heads = [gr for gr in groups if gr.key == "layers.0.ssm.A_log:0"][0]
    widths = {s.path.rsplit(".", 1)[1]: len(s.positions)
              for s in heads.units[0].slices}
    assert widths == {"A_log": 1, "D": 1, "dt_bias": 1, "w_dt": 1,
                      "w_out": 1, "w_x": 1, "w_z": 1, "conv_w": 16,
                      "norm": 16}
    pr = prune_model(tm, tp, 0.5)
    c = pr.cfg
    assert (c.ssm_n_heads, c.ssm_head_dim, c.ssm_state, c.d_model) == \
        (4, 8, 8, tm.cfg.d_model)
    ssm = pr.params["layers"]["ssm"]
    assert tuple(ssm["w_x"].shape) == (2, 64, 4, 8)
    assert tuple(ssm["conv_w"].shape) == (2, 4, 4 * 8 + 2 * 8)
    assert tuple(ssm["w_out"].shape) == (2, 4, 8, 64)
    # the analytic count follows the pruned SSD width (nh * head_dim), not
    # expand * d_model, and is the tensors' own count
    held = sum(t.numel() for _, t in tree_paths(pr.params))
    assert c.param_count() == held
    assert c.param_count() < 0.5 * tm.cfg.param_count()


def test_trace_takes_the_plain_branch(monkeypatch):
    """The analysis trace runs on fake tensors, which the K3 launch through
    ctypes cannot take: ``trace_model`` traces ``use_kernels=False``.
    Shown without a card by routing every tensor to the kernel branch and
    making the kernel raise: the forward then fails, the trace does not."""
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.models import ssm as t_ssm

    def no_kernel(*a, **k):
        raise AssertionError("K3 reached")
    monkeypatch.setattr(t_ssm, "_on_kernel", lambda cfg, x: cfg.use_kernels)
    monkeypatch.setattr(ssd_ops, "ssd_scan", no_kernel)
    _, _, tm, tp = models("mamba2")
    assert tm.cfg.use_kernels
    toks = torch.zeros((1, 16), dtype=torch.int32)
    with pytest.raises(AssertionError, match="K3 reached"):
        tm.forward(tp, {"tokens": toks})
    g, _ = trace_model(tm, tp)
    assert {"cumsum", "pad", "conv1d", "softplus"} <= \
        {op.prim for op in g.ops}
    assert prune_model(tm, tp, 0.5).cfg.ssm_n_heads == 4
