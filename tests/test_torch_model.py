"""PyTorch port vs JAX reference: the dense-family model on converted weights.

The JAX model is initialised (and, for one case, pruned by the JAX pruner);
its parameters cross as numpy arrays through ``repro_torch.convert``; both
sides then get the same numpy-made tokens.  Compared: full-sequence logits,
a 16-step contiguous-cache rollout, and the paged decode / prefill / verify
steps **with the pool contents they leave behind** (f32 and int8 pools).
Reduced configs, f32; tolerance 1e-5 absolute on logits and pool values
unless a test gives a reason for another.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as j_get_config, reduced as j_reduced
from repro.core.pruner import prune_model
from repro.models import build as j_build
from repro_torch import convert
from repro_torch.models import build as t_build

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ATOL = 1e-5
ARCHS = ["tinyllama-1.1b", "qwen3-1.7b", "phi3-medium-14b", "granite-20b"]

_MODELS: dict = {}


def models(name: str, pruned: bool = False):
    """(JAX model, JAX params, port model, port params) on shared weights."""
    key = (name, pruned)
    if key not in _MODELS:
        jm = j_build(j_reduced(j_get_config(name)))
        jp = jm.init(jax.random.PRNGKey(0))
        if pruned:
            pr = prune_model(jm, jp, 0.5, criterion="l1")
            jm, jp = j_build(pr.cfg), pr.params
        tm = t_build(convert.convert_config(dataclasses.asdict(jm.cfg)))
        tp = convert.convert_params(jax.tree.map(np.asarray, jp))
        _MODELS[key] = (jm, jp, tm, tp)
    return _MODELS[key]


def T(a, dtype=torch.int32):
    return torch.from_numpy(np.asarray(a)).to(dtype)


@pytest.mark.parametrize("name", ARCHS)
def test_forward_logits(name):
    jm, jp, tm, tp = models(name)
    toks = np.random.default_rng(0).integers(
        0, jm.cfg.vocab_size, size=(2, 12)).astype(np.int32)
    ref = np.asarray(jm.forward(jp, {"tokens": jnp.asarray(toks)}))
    with torch.no_grad():
        got = tm.forward(tp, {"tokens": T(toks)}).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)
    jl, _ = jm.loss(jp, {"tokens": jnp.asarray(toks)})
    tl, parts = tm.loss(tp, {"tokens": T(toks)})
    assert abs(float(jl) - float(tl)) < ATOL and float(parts["aux"]) == 0.0


@pytest.mark.parametrize("name", ARCHS)
def test_decode_rollout_16_steps(name):
    jm, jp, tm, tp = models(name)
    toks = np.random.default_rng(1).integers(
        0, jm.cfg.vocab_size, size=(2, 16)).astype(np.int32)
    jc = jm.init_cache(batch=2, max_len=16)
    tc = tm.init_cache(batch=2, max_len=16, device="cpu")
    step = jax.jit(jm.decode_step)
    with torch.no_grad():
        for t in range(16):
            jl, jc = step(jp, jc, jnp.asarray(toks[:, t]), jnp.int32(t))
            tl, tc = tm.decode_step(tp, tc, T(toks[:, t]), t)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                       atol=ATOL, rtol=0, err_msg=f"t={t}")
    for n in ("k", "v"):
        np.testing.assert_allclose(tc[n].numpy(), np.asarray(jc[n]),
                                   atol=ATOL, rtol=0)


def _assert_pools(tc, jc, quant, where):
    """Pool contents outside the null block (block 0 takes the duplicate
    writes of idle and padded rows, in no defined order)."""
    for n in ("k", "v"):
        a, b = tc[n][:, 1:], np.asarray(jc[n])[:, 1:]
        if quant:
            # K/V differ by ~1e-7 across frameworks, so a value that sits on
            # a rounding boundary may land one int8 step apart
            d = np.abs(a.numpy().astype(np.int32) - b.astype(np.int32))
            assert d.max() <= 1 and (d > 0).mean() < 5e-3, (where, n)
            np.testing.assert_allclose(
                tc[n + "_scale"][:, 1:].numpy(),
                np.asarray(jc[n + "_scale"])[:, 1:], atol=1e-6, rtol=0)
        else:
            np.testing.assert_allclose(a.numpy(), b, atol=ATOL, rtol=0,
                                       err_msg=f"{where} {n}")


def _paged_sequence(jm, jp, tm, tp, pool, seed):
    """prefill (ragged valid) -> decode -> verify on B=3 slots; every step's
    logits and pools are compared."""
    quant = pool == "int8"
    # one rare one-step int8 difference in a stored K/V row moves logits
    # by ~1e-3; f32 pools stay at 1e-5
    atol = 5e-3 if quant else ATOL
    rng = np.random.default_rng(seed)
    V = jm.cfg.vocab_size
    B, C, bs, NB = 3, 4, 4, 6
    P = B * NB + 1
    tables = np.arange(1, P).reshape(B, NB).astype(np.int32)
    jc = jm.init_paged_cache(P, bs, B, dtype=pool)
    tc = tm.init_paged_cache(P, bs, B, dtype=pool, device="cpu")
    if quant:
        assert tc["k"].dtype == torch.int8 and "v_scale" in tc
    slots = np.arange(B, dtype=np.int32)

    def chunk(starts, valid):
        toks = rng.integers(0, V, size=(B, C)).astype(np.int32)
        pos = (np.asarray(starts)[:, None] + np.arange(C)[None]).astype(
            np.int32)
        tab = np.where((np.asarray(valid) > 0)[:, None], tables, 0)
        return toks, pos, tab.astype(np.int32), np.asarray(valid, np.int32)

    with torch.no_grad():
        # two prefill chunks: slot 1 idle in the first, partial chunks after
        for starts, valid in (([0, 0, 0], [4, 0, 3]), ([4, 0, 3], [2, 4, 0])):
            toks, pos, tab, val = chunk(starts, valid)
            jl, jc = jm.paged_prefill_step(
                jp, jc, jnp.asarray(toks), jnp.asarray(pos),
                jnp.asarray(slots), jnp.asarray(tab), jnp.asarray(val))
            tl, tc = tm.paged_prefill_step(tp, tc, T(toks), T(pos), T(slots),
                                           T(tab), T(val))
            rows = val > 0
            np.testing.assert_allclose(tl.numpy()[rows],
                                       np.asarray(jl)[rows], atol=atol,
                                       rtol=0)
            assert np.isfinite(tl.numpy()).all()
            _assert_pools(tc, jc, quant, "prefill")
        # decode: slots at depths 6, 4, 3; slot 2 inactive (zeroed table)
        positions = np.asarray([6, 4, 3], np.int32)
        active = np.asarray([True, True, False])
        tab = np.where(active[:, None], tables, 0).astype(np.int32)
        tok = rng.integers(0, V, size=(B,)).astype(np.int32)
        jl, jc = jm.paged_decode_step(
            jp, jc, jnp.asarray(tok), jnp.asarray(positions),
            jnp.asarray(tab), jnp.asarray(active))
        tl, tc = tm.paged_decode_step(tp, tc, T(tok), T(positions), T(tab),
                                      T(active, torch.bool))
        np.testing.assert_allclose(tl.numpy()[active],
                                   np.asarray(jl)[active], atol=atol, rtol=0)
        _assert_pools(tc, jc, quant, "decode")
        # verify: logits at every row of a (B, C) chunk over the history
        toks, pos, tab, val = chunk([7, 5, 0], [4, 3, 0])
        jl, jc = jm.paged_verify_step(
            jp, jc, jnp.asarray(toks), jnp.asarray(pos), jnp.asarray(slots),
            jnp.asarray(tab), jnp.asarray(val))
        tl, tc = tm.paged_verify_step(tp, tc, T(toks), T(pos), T(slots),
                                      T(tab), T(val))
        assert tuple(tl.shape) == (B, C, V)
        real = np.arange(C)[None] < val[:, None]
        np.testing.assert_allclose(tl.numpy()[real], np.asarray(jl)[real],
                                   atol=atol, rtol=0)
        _assert_pools(tc, jc, quant, "verify")


@pytest.mark.parametrize("pool", [None, "int8"], ids=["f32-pool", "int8-pool"])
@pytest.mark.parametrize("name", ARCHS)
def test_paged_steps_and_pool_contents(name, pool):
    jm, jp, tm, tp = models(name)
    _paged_sequence(jm, jp, tm, tp, pool, seed=2)


def test_paged_steps_vs_interpret_pallas_kernel():
    """The JAX side with ``use_pallas=True`` runs its Pallas kernel in
    interpret mode; the port's plain version agrees with it too."""
    jm, jp, tm, tp = models("tinyllama-1.1b")
    jk = j_build(jm.cfg.replace(use_pallas=True))
    _paged_sequence(jk, jp, tm, tp, None, seed=3)


@pytest.mark.parametrize("pool", [None, "int8"], ids=["f32-pool", "int8-pool"])
def test_jax_pruned_model_crosses_and_serves(pool):
    """A 50 %-pruned tinyllama — pruned by the JAX pruner — is a plain
    smaller model: its config crosses as a dict, its parameters as numpy,
    and every step agrees (head dims are no longer what the dense config
    had)."""
    jm, jp, tm, tp = models("tinyllama-1.1b", pruned=True)
    dense = j_reduced(j_get_config("tinyllama-1.1b"))
    assert jm.cfg.param_count() < dense.param_count()
    assert tm.cfg.head_dim_ == jm.cfg.head_dim_
    assert tm.cfg.v_head_dim_ == jm.cfg.v_head_dim_
    toks = np.random.default_rng(4).integers(
        0, jm.cfg.vocab_size, size=(2, 10)).astype(np.int32)
    ref = np.asarray(jm.forward(jp, {"tokens": jnp.asarray(toks)}))
    with torch.no_grad():
        got = tm.forward(tp, {"tokens": T(toks)}).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)
    _paged_sequence(jm, jp, tm, tp, pool, seed=5)


def test_init_is_seeded_and_shaped_like_the_reference():
    jm, jp, tm, _ = models("qwen3-1.7b")
    a = tm.init(seed=3, device="cpu")
    b = tm.init(seed=3, device="cpu")
    c = tm.init(seed=4, device="cpu")
    assert torch.equal(a["layers"]["attn"]["wq"], b["layers"]["attn"]["wq"])
    assert not torch.equal(a["tok_embed"], c["tok_embed"])
    jshapes = {jax.tree_util.keystr(k): tuple(v.shape)
               for k, v in jax.tree_util.tree_leaves_with_path(jp)}

    def walk(tree, path=""):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from walk(v, f"{path}['{k}']")
        else:
            yield path, tuple(tree.shape)
    assert dict(walk(a)) == jshapes
    assert float(a["layers"]["ln1"].min()) == 1.0       # norms start at one


def test_stack_unstack_roundtrip_and_unrolled_forward():
    from repro_torch.models import transformer as tf
    _, _, tm, tp = models("tinyllama-1.1b")
    un = tf.unstack_layers(tp, tm.cfg.num_layers)
    assert isinstance(un["layers"], list) and len(un["layers"]) == 2
    re = tf.stack_layers(un)
    assert torch.equal(re["layers"]["mlp"]["w_up"], tp["layers"]["mlp"]["w_up"])
    toks = T(np.arange(8).reshape(1, 8))
    with torch.no_grad():
        assert torch.equal(tm.forward(un, {"tokens": toks}),
                           tm.forward(tp, {"tokens": toks}))


@pytest.mark.parametrize("name", ["qwen3-moe-30b-a3b", "mamba2-1.3b",
                                  "hymba-1.5b", "paligemma-3b",
                                  "hubert-xlarge"])
def test_other_families_raise_naming_the_roadmap(name):
    from repro_torch.configs import get_config, reduced
    cfg = reduced(get_config(name))
    # every family is ported whole (model, magnitude and OBSPA pruning;
    # serving for the decoders; tests/test_torch_moe*.py,
    # test_torch_ssm*.py, test_torch_hybrid.py, test_torch_obspa_ssm.py,
    # test_torch_encoder*.py, test_torch_vlm.py): the model builds and
    # OBSPA prunes it on reduced data
    from repro_torch.core.obspa import obspa_prune
    from repro_torch.data.synthetic import batches
    m = t_build(cfg)
    calib = batches(cfg, "datafree", 1, 2, 40, seed=5, device="cpu")
    res = obspa_prune(m, m.init(device="cpu"), 0.5, calib,
                      calib_mode="datafree")
    if cfg.family == "moe":
        assert res.cfg.n_experts == cfg.n_experts // 2
    elif cfg.family in ("ssm", "hybrid"):
        assert res.cfg.ssm_n_heads == cfg.ssm_n_heads // 2
    else:
        assert res.cfg.n_heads == cfg.n_heads // 2
    assert res.report["groups_with_obs"] > 0
    with torch.no_grad():
        out = t_build(res.cfg).forward(res.params, calib[0])
    assert torch.isfinite(out).all()
    # a family the reference does not register is refused
    with pytest.raises(NotImplementedError, match="no model of family"):
        t_build(cfg.replace(family="rnn"))


def test_entry_points_need_cuda_unless_cpu_is_asked_for():
    _, _, tm, _ = models("tinyllama-1.1b")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for call in (lambda: tm.init(seed=0),
                 lambda: tm.init_cache(1, 8),
                 lambda: tm.init_paged_cache(4, 4, 1)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
