"""PyTorch port vs JAX reference: the SSM family (Mamba-2) on converted
weights.

Reduced ``mamba2-1.3b`` (2 layers, d 64, 8 SSM heads × head_dim 16, state
16, chunk 16, f32) is initialised by the JAX package; its parameters cross
as numpy arrays through ``repro_torch.convert``; both sides then get the
same numpy-made inputs.  Compared per module (``ssm_block``,
``ssm_prefill`` with ragged ``valid`` and a carried conv/state,
``ssm_decode``), then the model: full-sequence logits against JAX with
``use_pallas`` off and on (the Pallas SSD kernel in interpret mode), a
16-step contiguous-cache rollout, and the paged steps with the per-slot
state they leave behind.  Tolerance 1e-5 absolute (f32) unless a test gives
a reason for another.  The modules are also compared in bf16, the type the
model is deployed in.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as j_get_config, reduced as j_reduced
from repro.core.pruner import prune_model as j_prune_model
from repro.models import build as j_build
from repro.models import ssm as j_ssm
from repro_torch import convert
from repro_torch.models import build as t_build
from repro_torch.models import ssm as t_ssm

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ATOL = 1e-5
_MODELS: dict = {}


def models(pruned: bool = False):
    """(JAX model, JAX params, port model, port params) on shared weights;
    ``pruned`` = 50 % L1-pruned by the JAX pruner, then converted."""
    if pruned not in _MODELS:
        jm = j_build(j_reduced(j_get_config("mamba2-1.3b")))
        jp = jm.init(jax.random.PRNGKey(0))
        if pruned:
            pr = j_prune_model(jm, jp, 0.5, criterion="l1")
            jm, jp = j_build(pr.cfg), pr.params
        tm = t_build(convert.convert_config(dataclasses.asdict(jm.cfg)))
        tp = convert.convert_params(jax.tree.map(np.asarray, jp))
        _MODELS[pruned] = (jm, jp, tm, tp)
    return _MODELS[pruned]


def T(a, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(np.asarray(a)))
    return t if dtype is None else t.to(dtype)


def layer0(jp, tp):
    """Layer 0's SSM parameters on both sides."""
    return (jax.tree.map(lambda a: a[0], jp["layers"]["ssm"]),
            {k: v[0] for k, v in tp["layers"]["ssm"].items()})


def close(got: torch.Tensor, ref, atol=ATOL, what=""):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(ref, np.float32), atol=atol, rtol=0,
                               err_msg=what)


def rand_cache(cfg, B, seed):
    """A non-zero conv window and state, as a slot mid-sequence holds."""
    rng = np.random.default_rng(seed)
    nh, hp, n = cfg.ssm_n_heads, cfg.ssm_head_dim, cfg.ssm_state
    conv = rng.normal(size=(B, cfg.ssm_conv - 1, nh * hp + 2 * n))
    state = rng.normal(size=(B, nh, hp, n))
    return conv.astype(np.float32), (0.3 * state).astype(np.float32)


@pytest.mark.parametrize("S", [16, 37])
def test_ssm_block_vs_jax(S):
    """One chunk exactly, and a length the block pads to a chunk multiple."""
    jm, jp, tm, tp = models()
    jl, tl = layer0(jp, tp)
    x = np.random.default_rng(S).normal(size=(2, S, 64)).astype(np.float32)
    ref = j_ssm.ssm_block(jl, jm.cfg, jnp.asarray(x))
    with torch.no_grad():
        got = t_ssm.ssm_block(tl, tm.cfg, T(x))
    close(got, ref)


@pytest.mark.parametrize("fresh", [True, False], ids=["zero-state",
                                                       "carried-state"])
def test_ssm_prefill_vs_jax(fresh):
    """Ragged ``valid`` (a full chunk, a partial one, an idle row) from a
    zero or a carried conv window / state: outputs at the valid rows, the
    next chunk's conv context and the state are the reference's."""
    jm, jp, tm, tp = models()
    jl, tl = layer0(jp, tp)
    B, C = 3, 16
    conv, state = rand_cache(jm.cfg, B, seed=7)
    if fresh:
        conv, state = np.zeros_like(conv), np.zeros_like(state)
    x = np.random.default_rng(8).normal(size=(B, C, 64)).astype(np.float32)
    valid = np.asarray([16, 5, 0], np.int32)
    jout, jc = j_ssm.ssm_prefill(
        jl, jm.cfg, jnp.asarray(x),
        j_ssm.SSMCache(jnp.asarray(conv), jnp.asarray(state)),
        jnp.asarray(valid))
    with torch.no_grad():
        tout, tc = t_ssm.ssm_prefill(tl, tm.cfg, T(x),
                                     t_ssm.SSMCache(T(conv), T(state)),
                                     T(valid))
    real = np.arange(C)[None] < valid[:, None]
    close(tout[torch.from_numpy(real)], np.asarray(jout)[real])
    close(tc.conv, jc.conv, what="conv")
    close(tc.state, jc.state, what="state")
    # a row with no tokens keeps its state exactly (dt = 0 at every pad)
    np.testing.assert_array_equal(tc.state[2].numpy(), state[2])


def test_ssm_decode_vs_jax():
    jm, jp, tm, tp = models()
    jl, tl = layer0(jp, tp)
    conv, state = rand_cache(jm.cfg, 2, seed=9)
    x = np.random.default_rng(10).normal(size=(2, 1, 64)).astype(np.float32)
    jout, jc = j_ssm.ssm_decode(
        jl, jm.cfg, jnp.asarray(x),
        j_ssm.SSMCache(jnp.asarray(conv), jnp.asarray(state)))
    with torch.no_grad():
        tout, tc = t_ssm.ssm_decode(tl, tm.cfg, T(x),
                                    t_ssm.SSMCache(T(conv), T(state)))
    close(tout, jout)
    close(tc.conv, jc.conv, what="conv")
    close(tc.state, jc.state, what="state")


def bf16_models():
    """The reduced model in bf16 (its deployment type; ``A_log``, ``D`` and
    ``dt_bias`` stay f32), initialised by the JAX package and converted."""
    if "bf16" not in _MODELS:
        jm = j_build(j_reduced(j_get_config("mamba2-1.3b")).replace(
            dtype="bfloat16"))
        jp = jm.init(jax.random.PRNGKey(0))
        tm = t_build(convert.convert_config(dataclasses.asdict(jm.cfg)))
        tp = convert.convert_params(jax.tree.map(np.asarray, jp))
        _MODELS["bf16"] = (jm, jp, tm, tp)
    return _MODELS["bf16"]


# bf16 outputs: both sides round the same f32 arithmetic to bf16 at the same
# places, so where a rounding falls differently an output is one bf16 step
# apart: max|Δ| held to 2^-7 of max|ref|.  f32 values (the state) to ATOL.
BF16_REL = 2.0 ** -7


@pytest.mark.parametrize("case", ["block-S16", "block-S37",
                                  "block-pallas-S37", "layer", "prefill",
                                  "decode"])
def test_bf16_modules_vs_jax(case):
    """The SSM modules in bf16 against JAX in bf16: the block (x f32 with dt
    applied, B/C bf16 into the scan — the kernel's mixed-type call — and
    ``_finish``'s casts), with JAX's scan in XLA and in the Pallas kernel
    (interpret mode); one whole layer (norm, block, residual) of the model;
    ``ssm_prefill`` and ``ssm_decode`` with a bf16 conv window and an f32
    state."""
    jm, jp, tm, tp = bf16_models()
    jl, tl = layer0(jp, tp)
    nh, hp, n = jm.cfg.ssm_n_heads, jm.cfg.ssm_head_dim, jm.cfg.ssm_state
    bf = jnp.bfloat16
    rng = np.random.default_rng(31)
    states = {}
    with torch.no_grad():
        if case.startswith("block"):
            S = int(case.split("-S")[1])
            x = rng.normal(size=(2, S, 64)).astype(np.float32)
            jcfg = jm.cfg.replace(use_pallas="pallas" in case)
            ref = j_ssm.ssm_block(jl, jcfg, jnp.asarray(x, bf))
            got = t_ssm.ssm_block(tl, tm.cfg, T(x, torch.bfloat16))
        elif case == "layer":
            from repro.models import transformer as jt
            from repro_torch.models import transformer as tt
            x = rng.normal(size=(2, 37, 64)).astype(np.float32)
            pos = np.broadcast_to(np.arange(37, dtype=np.int32), (2, 37))
            ref, _ = jt.layer_forward(
                jax.tree.map(lambda a: a[1], jp["layers"]), jm.cfg,
                jnp.asarray(x, bf), jnp.asarray(pos), None)
            got, _ = tt.layer_forward(tt._layer(tp["layers"], 1), tm.cfg,
                                      T(x, torch.bfloat16), T(pos))
        else:
            B = 3 if case == "prefill" else 2
            conv = rng.normal(size=(B, jm.cfg.ssm_conv - 1, nh * hp + 2 * n))
            state = (0.3 * rng.normal(size=(B, nh, hp, n))).astype(np.float32)
            jc = j_ssm.SSMCache(jnp.asarray(conv, bf), jnp.asarray(state))
            tc = t_ssm.SSMCache(T(conv, torch.bfloat16), T(state))
            if case == "prefill":
                x = rng.normal(size=(B, 16, 64)).astype(np.float32)
                valid = np.asarray([16, 5, 0], np.int32)
                jout, jc = j_ssm.ssm_prefill(jl, jm.cfg, jnp.asarray(x, bf),
                                             jc, jnp.asarray(valid))
                tout, tc = t_ssm.ssm_prefill(tl, tm.cfg, T(x, torch.bfloat16),
                                             tc, T(valid))
                real = np.arange(16)[None] < valid[:, None]
                got, ref = tout[torch.from_numpy(real)], \
                    np.asarray(jout.astype(jnp.float32))[real]
            else:
                x = rng.normal(size=(B, 1, 64)).astype(np.float32)
                ref, jc = j_ssm.ssm_decode(jl, jm.cfg, jnp.asarray(x, bf), jc)
                got, tc = t_ssm.ssm_decode(tl, tm.cfg, T(x, torch.bfloat16),
                                           tc)
            assert tc.conv.dtype == torch.bfloat16
            states = {"conv": (tc.conv, jc.conv), "state": (tc.state,
                                                            jc.state)}
    assert got.dtype == torch.bfloat16
    for name, (g, r) in [("out", (got, ref)), *states.items()]:
        r = np.asarray(jnp.asarray(r, jnp.float32))
        tol = ATOL if name == "state" else BF16_REL * np.abs(r).max()
        close(g, r, atol=tol, what=f"{case} {name}")


@pytest.mark.parametrize("pallas", [False, True], ids=["xla", "pallas"])
@pytest.mark.parametrize("pruned", [False, True], ids=["dense", "pruned"])
def test_forward_logits_vs_jax(pruned, pallas):
    """The mamba2 half of ``test_model_pallas_parity``: the port's forward
    against JAX with the XLA scan and with the Pallas kernel (interpret
    mode), dense and 50 %-pruned (SSM heads 8 -> 4, head_dim 16 -> 8,
    state 16 -> 8); a length that is no chunk multiple; the loss too."""
    jm, jp, tm, tp = models(pruned)
    if pallas:
        jm = j_build(jm.cfg.replace(use_pallas=True))
    toks = np.random.default_rng(11).integers(
        0, jm.cfg.vocab_size, size=(2, 37)).astype(np.int32)
    ref = np.asarray(jm.forward(jp, {"tokens": jnp.asarray(toks)}))
    with torch.no_grad():
        got = tm.forward(tp, {"tokens": T(toks)})
    close(got, ref)
    jloss, _ = jm.loss(jp, {"tokens": jnp.asarray(toks)})
    tloss, _ = tm.loss(tp, {"tokens": T(toks)})
    assert abs(float(jloss) - float(tloss)) < ATOL


def test_decode_rollout_16_steps():
    jm, jp, tm, tp = models()
    toks = np.random.default_rng(12).integers(
        0, jm.cfg.vocab_size, size=(2, 16)).astype(np.int32)
    jc = jm.init_cache(batch=2, max_len=16)
    tc = tm.init_cache(batch=2, max_len=16, device="cpu")
    assert set(tc) == {"conv", "state"} and tc["state"].dtype == torch.float32
    step = jax.jit(jm.decode_step)
    with torch.no_grad():
        for t in range(16):
            jl, jc = step(jp, jc, jnp.asarray(toks[:, t]), jnp.int32(t))
            tl, tc = tm.decode_step(tp, tc, T(toks[:, t]), t)
            close(tl, jl, what=f"t={t}")
        full = tm.forward(tp, {"tokens": T(toks)})
    for n in ("conv", "state"):
        close(tc[n], jc[n], what=n)
    # the recurrence and the chunked scan are one function
    close(tl, full[:, -1].numpy(), atol=2e-5)


def _paged_sequence(jm, jp, tm, tp, seed):
    """prefill (ragged valid, an idle row) -> decode with an inactive slot
    -> a slot restarting at position 0; logits and per-slot state
    compared after every step."""
    rng = np.random.default_rng(seed)
    V = jm.cfg.vocab_size
    B, C, bs, NB = 3, 16, 4, 10
    P = B * NB + 1
    tables = np.arange(1, P).reshape(B, NB).astype(np.int32)
    jc = jm.init_paged_cache(P, bs, B)
    tc = tm.init_paged_cache(P, bs, B, device="cpu")
    assert set(tc) == {"conv", "state"}
    slots = np.arange(B, dtype=np.int32)

    def states():
        for n in ("conv", "state"):
            close(tc[n], jc[n], what=n)

    with torch.no_grad():
        for starts, valid in (([0, 0, 0], [16, 0, 9]),
                              ([16, 0, 9], [3, 12, 0])):
            toks = rng.integers(0, V, size=(B, C)).astype(np.int32)
            pos = (np.asarray(starts)[:, None] + np.arange(C)).astype(
                np.int32)
            val = np.asarray(valid, np.int32)
            tab = np.where((val > 0)[:, None], tables, 0).astype(np.int32)
            jl, jc = jm.paged_prefill_step(
                jp, jc, jnp.asarray(toks), jnp.asarray(pos),
                jnp.asarray(slots), jnp.asarray(tab), jnp.asarray(val))
            tl, tc = tm.paged_prefill_step(tp, tc, T(toks), T(pos), T(slots),
                                           T(tab), T(val))
            rows = val > 0
            close(tl[torch.from_numpy(rows)], np.asarray(jl)[rows])
            states()
        # decode: slot 2 inactive (mid-prefill elsewhere) keeps its state;
        # then slot 0 restarts at position 0 (a reused slot) from zero
        for positions, active in (([19, 12, 0], [True, True, False]),
                                  ([0, 13, 0], [True, True, False])):
            positions = np.asarray(positions, np.int32)
            active = np.asarray(active)
            tab = np.where(active[:, None], tables, 0).astype(np.int32)
            tok = rng.integers(0, V, size=(B,)).astype(np.int32)
            before = tc["state"][:, 2].clone()
            jl, jc = jm.paged_decode_step(
                jp, jc, jnp.asarray(tok), jnp.asarray(positions),
                jnp.asarray(tab), jnp.asarray(active))
            tl, tc = tm.paged_decode_step(tp, tc, T(tok), T(positions),
                                          T(tab), T(active, torch.bool))
            close(tl[torch.from_numpy(active)], np.asarray(jl)[active])
            states()
            assert torch.equal(tc["state"][:, 2], before)
    # the reused slot's logits are those of a fresh one-token sequence
    fresh = tm.init_cache(batch=1, max_len=1, device="cpu")
    with torch.no_grad():
        one, _ = tm.decode_step(tp, fresh, T(tok[:1]), 0)
    close(tl[:1], one.numpy())


@pytest.mark.parametrize("pruned", [False, True], ids=["dense", "pruned"])
def test_paged_steps_and_state_vs_jax(pruned):
    _paged_sequence(*models(pruned), seed=13)


def test_init_is_seeded_and_shaped_like_the_reference():
    jm, jp, tm, _ = models()
    a = tm.init(seed=3, device="cpu")
    b = tm.init(seed=3, device="cpu")
    assert torch.equal(a["layers"]["ssm"]["w_x"], b["layers"]["ssm"]["w_x"])
    jleaves = {jax.tree_util.keystr(k): (tuple(v.shape), v.dtype.name)
               for k, v in jax.tree_util.tree_leaves_with_path(jp)}

    def walk(tree, path=""):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from walk(v, f"{path}['{k}']")
        else:
            yield path, (tuple(tree.shape), str(tree.dtype).split(".")[1])
    assert dict(walk(a)) == jleaves
    s = a["layers"]["ssm"]
    assert s["A_log"].dtype == s["D"].dtype == s["dt_bias"].dtype \
        == torch.float32
    close(s["A_log"][0], jp["layers"]["ssm"]["A_log"][0], atol=1e-6)
    assert a["layers"]["ln1"].shape == (2, 64) and "head" not in a
