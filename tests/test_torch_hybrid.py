"""PyTorch port vs JAX reference: the hybrid family (Hymba) on converted
weights — the model, its caches and its pruning (serving:
``test_torch_hybrid_serve.py``).

Reduced ``hymba-1.5b`` (2 layers, d 64, 4 query heads over 1 KV head of 16,
8 SSM heads x head_dim 16, state 16, SSM chunk 16, window 32 on layer 1,
layer 0 global, f32) is initialised by the JAX package; its parameters cross
as numpy arrays through ``repro_torch.convert``; both sides then get the
same numpy-made inputs.  Every sequence is longer than the window (32), so
the window cuts, and no length is a multiple of the SSM chunk.  Compared:
full-sequence logits (also with ``sliding_window = 8`` on every layer), a
contiguous-cache rollout, the paged steps with the KV pools and the per-slot
state they leave behind, and L1 pruning (groups, units, config, pruned
logits).  Tolerance 1e-5 absolute (f32) unless a test gives a reason for
another.
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
from repro.models import build as j_build
from repro_torch import convert
from repro_torch.core.graph import tree_map_paths, tree_paths
from repro_torch.core.pruner import analyze, prunable, prune_model
from repro_torch.models import build as t_build
from repro_torch.models import transformer as tf
from test_torch_pruning import summary

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ATOL = 1e-5
VARIANTS = {
    "reduced": {},
    # every layer windowed, as tests/test_models.py's sliding-window case
    "window8": {"sliding_window": 8, "global_layers": ()},
}
_MODELS: dict = {}


@pytest.fixture(autouse=True)
def one_thread():
    """Many small products: one intra-op thread under the test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def models(variant: str = "reduced"):
    """(JAX model, JAX params, port model, port params) on shared weights
    (a variant changes only the windows, so every variant shares the
    reduced model's weights; they are drawn by the JAX package's ``init``
    under ``jit``, which is quicker here than eager)."""
    if variant not in _MODELS:
        jcfg = j_reduced(j_get_config("hymba-1.5b")).replace(
            **VARIANTS[variant])
        jm = j_build(jcfg)
        if variant == "reduced":
            jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
            tp = convert.convert_params(jax.tree.map(np.asarray, jp))
        else:
            _, jp, _, tp = models()
        tm = t_build(convert.convert_config(dataclasses.asdict(jcfg)))
        _MODELS[variant] = (jm, jp, tm, tp)
    return _MODELS[variant]


def T(a, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(np.asarray(a)))
    return t if dtype is None else t.to(dtype)


def close(got, ref, atol=ATOL, what=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(ref, np.float32), atol=atol,
                               rtol=0, err_msg=what)


def test_layer_windows_and_cache_layout():
    """Layer 0 is global (window 0: plain causal), layer 1 windowed; the
    caches hold KV and the per-slot recurrent state together, shaped as the
    reference's; the analytic parameter count is the tensors' (the
    reference's leaves out the SSM ``dt_bias`` and ``norm``) and
    ``dummy_batch`` gives int32 tokens."""
    jm, _, tm, tp = models()
    cfg = tm.cfg
    held = sum(t.numel() for _, t in tree_paths(tp))
    assert cfg.param_count() == held
    assert cfg.param_count() == jm.cfg.param_count() + cfg.num_layers * (
        cfg.ssm_n_heads + cfg.d_inner)
    batch = tm.dummy_batch(2, 40, device="cpu")
    assert batch["tokens"].shape == (2, 40) and \
        batch["tokens"].dtype == torch.int32
    assert [tf.layer_window(cfg, i) for i in range(cfg.num_layers)] == \
        [0, 32]
    dense = convert.convert_config(dataclasses.asdict(
        j_reduced(j_get_config("tinyllama-1.1b"))))
    assert tf.layer_window(dense, 1) == 0
    for got, ref in ((tm.init_cache(2, 40, device="cpu"),
                      jm.init_cache(batch=2, max_len=40)),
                     (tm.init_paged_cache(9, 4, 3, device="cpu"),
                      jm.init_paged_cache(9, 4, 3))):
        assert set(got) == {"k", "v", "conv", "state"} == set(ref)
        for n in got:
            assert tuple(got[n].shape) == tuple(ref[n].shape), n
        assert got["state"].dtype == torch.float32


@pytest.mark.parametrize("variant,S", [("reduced", 40), ("reduced", 64),
                                       ("window8", 40)])
def test_forward_logits_vs_jax(variant, S):
    jm, jp, tm, tp = models(variant)
    toks = np.random.default_rng(S).integers(
        0, jm.cfg.vocab_size, size=(2, S)).astype(np.int32)
    ref = np.asarray(jm.forward(jp, {"tokens": jnp.asarray(toks)}))
    with torch.no_grad():
        got = tm.forward(tp, {"tokens": T(toks)})
    close(got, ref)
    jloss, _ = jm.loss(jp, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        tloss, _ = tm.loss(tp, {"tokens": T(toks)})
    assert abs(float(jloss) - float(tloss)) < ATOL


def test_forward_checkpointed_layers_equal_plain():
    """``remat`` passes each layer's window through the checkpoint."""
    _, _, tm, tp = models()
    toks = T(np.random.default_rng(3).integers(
        0, tm.cfg.vocab_size, size=(1, 41)).astype(np.int32))
    with torch.no_grad():
        ref = tm.forward(tp, {"tokens": toks})
    rm = t_build(tm.cfg.replace(remat=True))
    leaves = {p: t.clone().requires_grad_(t.is_floating_point())
              for p, t in tree_paths(tp)}
    tp2 = tree_map_paths(lambda p, _: leaves[p], tp)
    got = rm.forward(tp2, {"tokens": toks})
    assert torch.equal(got.detach(), ref)


def test_decode_rollout_past_the_window():
    """36 prompt tokens fed one at a time, then 16 greedy steps (positions
    to 51, past the window of 32): logits each step, tokens equal."""
    jm, jp, tm, tp = models()
    P, G = 36, 16
    prompt = np.random.default_rng(12).integers(
        0, jm.cfg.vocab_size, size=(2, P)).astype(np.int32)
    jc = jm.init_cache(batch=2, max_len=P + G)
    tc = tm.init_cache(batch=2, max_len=P + G, device="cpu")
    step = jax.jit(jm.decode_step)
    jtok, ttok = prompt[:, 0], T(prompt[:, 0])
    jgen, tgen = [], []
    with torch.no_grad():
        for t in range(P + G - 1):
            jl, jc = step(jp, jc, jnp.asarray(jtok), jnp.int32(t))
            tl, tc = tm.decode_step(tp, tc, ttok, t)
            close(tl, jl, what=f"t={t}")
            if t + 1 < P:
                jtok, ttok = prompt[:, t + 1], T(prompt[:, t + 1])
            else:
                jtok = np.asarray(jl).argmax(-1).astype(np.int32)
                ttok = tl.argmax(-1).to(torch.int32)
                jgen.append(jtok)
                tgen.append(ttok.numpy())
    np.testing.assert_array_equal(np.stack(tgen), np.stack(jgen))
    for n in ("k", "v", "conv", "state"):
        close(tc[n], jc[n], what=n)


def test_paged_steps_pools_and_state_vs_jax():
    """Three prefill chunks (ragged valid, an idle row, positions past the
    window) then decode steps past the window with an inactive slot: the
    logits, the KV pools (outside the null block) and the per-slot state
    after every step."""
    jm, jp, tm, tp = models()
    rng = np.random.default_rng(13)
    V = jm.cfg.vocab_size
    B, C, bs, NB = 3, 16, 4, 16
    P = B * NB + 1
    tables = np.arange(1, P).reshape(B, NB).astype(np.int32)
    jc = jm.init_paged_cache(P, bs, B)
    tc = tm.init_paged_cache(P, bs, B, device="cpu")
    slots = np.arange(B, dtype=np.int32)
    j_prefill = jax.jit(jm.paged_prefill_step)
    j_decode = jax.jit(jm.paged_decode_step)

    def pools_and_states(what):
        for n in ("conv", "state"):
            close(tc[n], jc[n], what=f"{what} {n}")
        for n in ("k", "v"):
            close(tc[n][:, 1:], np.asarray(jc[n])[:, 1:], what=f"{what} {n}")

    with torch.no_grad():
        for i, (starts, valid) in enumerate((
                ([0, 0, 0], [16, 0, 9]), ([16, 0, 9], [16, 12, 16]),
                ([32, 12, 25], [9, 16, 0]))):
            toks = rng.integers(0, V, size=(B, C)).astype(np.int32)
            pos = (np.asarray(starts)[:, None] + np.arange(C)).astype(
                np.int32)
            val = np.asarray(valid, np.int32)
            tab = np.where((val > 0)[:, None], tables, 0).astype(np.int32)
            jl, jc = j_prefill(
                jp, jc, jnp.asarray(toks), jnp.asarray(pos),
                jnp.asarray(slots), jnp.asarray(tab), jnp.asarray(val))
            tl, tc = tm.paged_prefill_step(tp, tc, T(toks), T(pos), T(slots),
                                           T(tab), T(val))
            rows = val > 0
            close(tl[torch.from_numpy(rows)], np.asarray(jl)[rows],
                  what=f"prefill {i}")
            pools_and_states(f"prefill {i}")
        # decode past the window; slot 2 rides inactive and keeps its state
        positions = np.asarray([41, 28, 25], np.int32)
        for i in range(6):
            active = np.asarray([True, True, i >= 3])
            tab = np.where(active[:, None], tables, 0).astype(np.int32)
            tok = rng.integers(0, V, size=(B,)).astype(np.int32)
            before = tc["state"][:, 2].clone()
            jl, jc = j_decode(
                jp, jc, jnp.asarray(tok), jnp.asarray(positions),
                jnp.asarray(tab), jnp.asarray(active))
            tl, tc = tm.paged_decode_step(tp, tc, T(tok), T(positions),
                                          T(tab), T(active, torch.bool))
            close(tl[torch.from_numpy(active)], np.asarray(jl)[active],
                  what=f"decode {i}")
            pools_and_states(f"decode {i}")
            if not active[2]:
                assert torch.equal(tc["state"][:, 2], before)
            positions = positions + active.astype(np.int32)


# ---------------------------------------------------------------------------
# Pruning
# ---------------------------------------------------------------------------

def test_l1_groups_units_and_config_match_jax():
    """Per layer: heads (the one KV head and its 4 query heads are
    protected, so query heads), v_head_dim, d_ff, SSM heads, SSM head_dim
    and state; L1 at 0.5 prunes the same units and reads back the same
    config as the JAX package, and the pruned logits agree."""
    jm, jp, tm, tp = models()
    _, jgroups, _ = j_analyze(jm, jp)
    _, tgroups, _ = analyze(tm, tp)
    assert summary(tgroups) == summary(jgroups)
    assert {gr.kind for gr in prunable(tgroups)} >= {"heads", "mlp",
                                                     "ssm_heads",
                                                     "ssm_state"}
    jr = j_prune_model(jm, jp, 0.5, criterion="l1")
    tr = prune_model(tm, tp, 0.5, criterion="l1")
    assert tr.pruned_units == jr.pruned_units
    assert tr.report["units_pruned"] == jr.report["units_pruned"]
    assert tr.cfg == convert.convert_config(dataclasses.asdict(jr.cfg))
    c = tr.cfg
    assert (c.n_heads, c.v_head_dim_, c.d_ff, c.ssm_n_heads, c.ssm_head_dim,
            c.ssm_state) == (2, 8, 64, 4, 8, 8)
    jleaves = dict(tree_paths(jax.tree.map(np.asarray, jr.params)))
    for path, leaf in tree_paths(tr.params):
        np.testing.assert_array_equal(leaf.numpy(), jleaves[path])
    toks = np.random.default_rng(0).integers(
        0, jm.cfg.vocab_size, size=(2, 45)).astype(np.int32)
    ref = np.asarray(j_build(jr.cfg).forward(jr.params,
                                             {"tokens": jnp.asarray(toks)}))
    with torch.no_grad():
        got = t_build(tr.cfg).forward(tr.params, {"tokens": T(toks)})
        p64 = tree_map_paths(lambda _, t: t.double()
                             if t.is_floating_point() else t, tr.params)
        exact = tf.logits_from_hidden(
            p64, tr.cfg, tf.forward(p64, tr.cfg, {"tokens": T(toks)})[0])
    # the pruned weights are bitwise the same, but this model's f32
    # evaluation is 2-3e-5 away from its float64 one in both packages
    # (layer 1 amplifies layer 0's rounding), so the two f32 evaluations
    # are held to that distance; each is held to the float64 one too
    close(got, ref, atol=3e-5)
    close(got, exact, atol=3e-5)
    close(exact, ref, atol=3e-5)
    held = sum(t.numel() for _, t in tree_paths(tr.params))
    assert c.param_count() == held


