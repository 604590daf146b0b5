"""PyTorch port vs JAX reference: the moe family on converted weights — the
MoE block and the model (serving: ``test_torch_moe_serve.py``; pruning:
``test_torch_moe_prune.py``).

Reduced ``qwen2-moe-a2.7b`` (2 layers, d 64, 8 experts top-2 of width 32,
2 shared experts of 64, f32) and reduced ``qwen3-moe-30b-a3b`` (qk_norm,
4 query heads over 1 KV head, no shared experts) are initialised by the JAX
package; the parameters cross as numpy arrays through
``repro_torch.convert`` and both sides get the same numpy-made inputs.

Routing is discrete: where a token's k-th and (k+1)-th router
probabilities lie within the two frameworks' f32 rounding (~1e-7) of each
other, an expert could flip on one machine and not on another.  So every
comparison first compares the chosen experts (``top_e``) exactly and
asserts, as a stated precondition of the seeded inputs, that the smallest
such gap over the real tokens exceeds ``MARGIN``; only then are outputs
compared: 1e-5 absolute in f32, the aux loss to 1e-6.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as j_get_config, reduced as j_reduced
from repro.models import build as j_build
from repro.models import moe as j_moe
from repro_torch import convert
from repro_torch.core.graph import tree_map_paths, tree_paths
from repro_torch.models import build as t_build
from repro_torch.models import moe as t_moe
from repro_torch.models import transformer as tf

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ATOL = 1e-5
AUX_ATOL = 1e-6
MARGIN = 1e-5
ARCHS = {"qwen2": "qwen2-moe-a2.7b", "qwen3": "qwen3-moe-30b-a3b"}
_MODELS: dict = {}


@pytest.fixture(autouse=True)
def one_thread():
    """Many small products: one intra-op thread under the test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def models(arch: str = "qwen2"):
    """(JAX model, JAX params, port model, port params) on shared weights,
    drawn by the JAX package's ``init`` under ``jit``."""
    if arch not in _MODELS:
        jcfg = j_reduced(j_get_config(ARCHS[arch]))
        jm = j_build(jcfg)
        jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
        tm = t_build(convert.convert_config(dataclasses.asdict(jcfg)))
        tp = convert.convert_params(jax.tree.map(np.asarray, jp))
        _MODELS[arch] = (jm, jp, tm, tp)
    return _MODELS[arch]


def T(a, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(np.asarray(a)))
    return t if dtype is None else t.to(dtype)


def close(got, ref, atol=ATOL, what=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(ref, np.float32), atol=atol,
                               rtol=0, err_msg=what)


def routing(router, x, k: int, mask=None):
    """The experts each token picks (T, k) and the smallest gap between a
    real token's k-th and (k+1)-th router probability (port arithmetic)."""
    x = torch.as_tensor(np.asarray(x, np.float32)).reshape(
        -1, router.shape[0])
    probs = torch.softmax(x @ router.float(), dim=-1)
    top = torch.topk(probs, k + 1, dim=-1).values
    gap = top[:, k - 1] - top[:, k]
    if mask is not None:
        gap = gap[torch.as_tensor(np.asarray(mask)).reshape(-1)]
    return torch.topk(probs, k, dim=-1).indices.numpy(), float(gap.min())


def assert_same_routing(jrouter, trouter, jx, tx, k, mask=None, what=""):
    """JAX's chosen experts on its input equal the port's on its input,
    and no real token is near a tie."""
    j_e = np.asarray(jax.lax.top_k(jax.nn.softmax(
        jnp.asarray(jx, jnp.float32).reshape(-1, jrouter.shape[0])
        @ jrouter, axis=-1), k)[1])
    t_e, gap = routing(trouter, tx, k, mask)
    assert gap > MARGIN, (f"{what}: seeded inputs put a real token's k-th "
                          f"and (k+1)-th router probabilities {gap:.2e} "
                          f"apart, within {MARGIN}")
    if mask is not None:
        keep = np.asarray(mask).reshape(-1)
        j_e, t_e = j_e[keep], t_e[keep]
    np.testing.assert_array_equal(t_e, j_e, err_msg=what)


def _layer_params(jp, tp, i):
    return (jax.tree.map(lambda a: a[i], jp["layers"]["moe"]),
            tf._layer(tp["layers"]["moe"], i))


CASES = {
    # B, S, padding rows, dispatch groups
    "dense": (3, 37, False, 1),
    "padded": (3, 37, True, 1),
    "groups2": (2, 36, True, 2),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_moe_block_vs_jax(arch, case):
    """One MoE block on seeded activations, with a token mask whose
    padding routes to the virtual expert: experts chosen, capacity drops,
    outputs and the aux loss."""
    jm, jp, tm, tp = models(arch)
    B, S, padded, G = CASES[case]
    jcfg = jm.cfg.replace(moe_dispatch_groups=G)
    tcfg = tm.cfg.replace(moe_dispatch_groups=G)
    rng = np.random.default_rng(S + G)
    x = rng.normal(size=(B, S, jcfg.d_model)).astype(np.float32)
    mask = None
    if padded:
        lens = rng.integers(1, S, size=B)
        mask = np.arange(S)[None, :] < lens[:, None]
    jl, tl = _layer_params(jp, tp, 1)
    assert_same_routing(jl["router"], tl["router"], x, x, jcfg.top_k, mask,
                        what=f"{arch} {case}")
    jy, jaux = j_moe.moe_block(jl, jcfg, jnp.asarray(x),
                               None if mask is None else jnp.asarray(mask))
    t_moe.reset_dropped()
    with torch.no_grad():
        ty, taux = t_moe.moe_block(tl, tcfg, T(x),
                                   None if mask is None else T(mask))
    if mask is None:
        assert t_moe.dropped_assignments() == 0 and not t_moe.dropped
    close(ty, jy, what="out")
    assert abs(float(taux) - float(jaux)) < AUX_ATOL
    assert taux.dtype == torch.float32 and ty.dtype == torch.float32


def test_capacity_drops_equal_and_counted():
    """A capacity of 8 slots an expert for 64 tokens routed top-2 over 8
    experts: the same assignments dropped as the reference's, the real
    tokens' drops counted (padding never counted: it never takes a
    slot), and the pads' rows left to the reference's values."""
    jm, jp, tm, tp = models("qwen2")
    cfg_j = jm.cfg.replace(capacity_factor=0.5)
    cfg_t = tm.cfg.replace(capacity_factor=0.5)
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 32, cfg_j.d_model)).astype(np.float32)
    mask = np.ones((2, 32), bool)
    mask[1, 20:] = False
    jl, tl = _layer_params(jp, tp, 0)
    assert_same_routing(jl["router"], tl["router"], x, x, cfg_j.top_k, mask)
    T_ = 64
    assert t_moe._capacity(cfg_t, T_) == j_moe._capacity(cfg_j, T_) == 8
    jy, jaux = j_moe.moe_block(jl, cfg_j, jnp.asarray(x), jnp.asarray(mask))
    t_moe.reset_dropped()
    with torch.no_grad():
        ty, taux = t_moe.moe_block(tl, cfg_t, T(x), T(mask))
    close(ty, jy)
    assert abs(float(taux) - float(jaux)) < AUX_ATOL
    # the reference's drops, recounted from its own dispatch
    top_e, _ = routing(tl["router"], x, cfg_t.top_k)
    top_e = np.where(mask.reshape(-1)[:, None], top_e, cfg_t.n_experts)
    flat = top_e.reshape(-1)
    order = np.argsort(flat, kind="stable")
    se = flat[order]
    sizes = np.bincount(se, minlength=cfg_t.n_experts + 1)
    rank = np.arange(len(se)) - (np.cumsum(sizes) - sizes)[se]
    real = se < cfg_t.n_experts
    want = int(((rank >= 8) & real).sum())
    assert want > 0
    assert t_moe.dropped_assignments() == want
    t_moe.reset_dropped()
    assert t_moe.dropped_assignments() == 0


def test_capacity_and_init_shapes():
    """``_capacity`` as the reference's at every width of the serving
    steps; the port's own init gives the reference's shapes and dtypes
    (router and shared gate f32 in a bf16 model)."""
    jm, jp, tm, _ = models("qwen2")
    for n in (1, 2, 7, 64, 128, 1000, 2048):
        assert t_moe._capacity(tm.cfg, n) == j_moe._capacity(jm.cfg, n)
    cfg = tm.cfg.replace(dtype="bfloat16")
    gen = torch.Generator().manual_seed(0)
    p = t_moe.moe_init(gen, cfg)
    ref = jax.eval_shape(lambda k: j_moe.moe_init(k, jm.cfg.replace(
        dtype="bfloat16")), jax.random.PRNGKey(0))
    for name in ("router", "w_gate", "w_up", "w_down"):
        assert tuple(p[name].shape) == ref[name].shape
    for name in ("w_gate", "w_up", "w_down", "gate"):
        assert tuple(p["shared"][name].shape) == ref["shared"][name].shape
    assert p["router"].dtype == p["shared"]["gate"].dtype == torch.float32
    assert p["w_gate"].dtype == p["shared"]["w_up"].dtype == torch.bfloat16


def _captured_moe_inputs(monkeypatch, module, attr="moe_block"):
    seen = []
    real = getattr(module, attr)

    def spy(params, cfg, x, token_mask=None):
        seen.append(np.asarray(x.detach().numpy() if isinstance(
            x, torch.Tensor) else x))
        return real(params, cfg, x, token_mask)

    monkeypatch.setattr(module, attr, spy)
    return seen


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_model_logits_and_loss_vs_jax(arch, monkeypatch):
    """Full-sequence logits (every layer's routing compared first), and
    ``loss`` = cross entropy + aux with both in its metrics."""
    jm, jp, tm, tp = models(arch)
    toks = np.random.default_rng(7).integers(
        0, jm.cfg.vocab_size, size=(2, 29)).astype(np.int32)
    j_in = _captured_moe_inputs(monkeypatch, j_moe)
    t_in = _captured_moe_inputs(monkeypatch, t_moe)
    ref = np.asarray(jm.forward(jp, {"tokens": jnp.asarray(toks)},
                                unroll=True))
    with torch.no_grad():
        got = tm.forward(tp, {"tokens": T(toks)})
    assert len(j_in) == len(t_in) == tm.cfg.num_layers
    for i, (jx, tx) in enumerate(zip(j_in, t_in)):
        jl, tl = _layer_params(jp, tp, i)
        assert_same_routing(jl["router"], tl["router"], jx, tx,
                            tm.cfg.top_k, what=f"layer {i}")
    close(got, ref)
    jloss, jmet = jm.loss(jp, {"tokens": jnp.asarray(toks)}, unroll=True)
    with torch.no_grad():
        tloss, tmet = tm.loss(tp, {"tokens": T(toks)})
    assert float(tmet["aux"]) > 0
    assert abs(float(tmet["aux"]) - float(jmet["aux"])) < AUX_ATOL
    assert abs(float(tmet["ce"]) - float(jmet["ce"])) < ATOL
    assert abs(float(tloss) - float(jloss)) < ATOL
    assert float(tloss) == pytest.approx(float(tmet["ce"] + tmet["aux"]))


def test_checkpointed_layers_carry_the_aux_loss():
    """``remat`` checkpoints each MoE layer with its aux loss: the loss and
    its gradients equal those without."""
    _, _, tm, tp = models("qwen2")
    toks = T(np.random.default_rng(3).integers(
        0, tm.cfg.vocab_size, size=(1, 17)).astype(np.int32))
    out = []
    for remat in (False, True):
        m = t_build(tm.cfg.replace(remat=remat))
        leaves = {p: t.clone().requires_grad_() for p, t in tree_paths(tp)}
        p2 = tree_map_paths(lambda p, _: leaves[p], tp)
        loss, met = m.loss(p2, {"tokens": toks})
        loss.backward()
        out.append((loss.detach(), met["aux"].detach(),
                    {p: t.grad for p, t in leaves.items()}))
    assert torch.equal(out[0][0], out[1][0])
    assert torch.equal(out[0][1], out[1][1])
    for p, g in out[0][2].items():
        assert torch.allclose(g, out[1][2][p], atol=1e-6, rtol=0), p


def test_decode_rollout_vs_jax(monkeypatch):
    """A contiguous-cache rollout (no token mask: one token a row a step),
    logits each step and the generated tokens."""
    jm, jp, tm, tp = models("qwen2")
    P, G = 9, 8
    prompt = np.random.default_rng(12).integers(
        0, jm.cfg.vocab_size, size=(2, P)).astype(np.int32)
    jc = jm.init_cache(batch=2, max_len=P + G)
    tc = tm.init_cache(batch=2, max_len=P + G, device="cpu")
    step = jax.jit(jm.decode_step)
    t_in = _captured_moe_inputs(monkeypatch, t_moe)
    jtok, ttok = prompt[:, 0], T(prompt[:, 0])
    jgen, tgen = [], []
    with torch.no_grad():
        for t in range(P + G - 1):
            jl, jc = step(jp, jc, jnp.asarray(jtok), jnp.int32(t))
            tl, tc = tm.decode_step(tp, tc, ttok, t)
            for i, x in enumerate(t_in[-tm.cfg.num_layers:]):
                _, gap = routing(tf._layer(tp["layers"]["moe"], i)["router"],
                                 x, tm.cfg.top_k)
                assert gap > MARGIN, (t, i, gap)
            close(tl, jl, what=f"t={t}")
            if t + 1 < P:
                jtok, ttok = prompt[:, t + 1], T(prompt[:, t + 1])
            else:
                jtok = np.asarray(jl).argmax(-1).astype(np.int32)
                ttok = tl.argmax(-1).to(torch.int32)
                jgen.append(jtok)
                tgen.append(ttok.numpy())
    np.testing.assert_array_equal(np.stack(tgen), np.stack(jgen))
    for n in ("k", "v"):
        close(tc[n], jc[n], what=n)


def test_gates_admit_moe_and_refuse_the_rest():
    from repro_torch.configs import get_config, reduced
    from repro_torch.core.obspa import obspa_prune
    from repro_torch.models.api import Model
    for name in ARCHS.values():
        tf.require_ported(reduced(get_config(name)))
    # experts outside the moe family (a combination no config of the
    # reference has) and an unknown family are refused, by the model and
    # by OBSPA, whose trace builds the model
    with pytest.raises(NotImplementedError, match="no model of family"):
        tf.require_ported(reduced(get_config("paligemma-3b")).replace(
            n_experts=4, top_k=2))
    rnn = reduced(get_config("paligemma-3b")).replace(family="rnn")
    with pytest.raises(NotImplementedError, match="no model of family"):
        obspa_prune(Model(rnn), {"w": torch.zeros(1)}, 0.5, [{}])
