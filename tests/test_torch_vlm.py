"""PyTorch port vs JAX reference: the vlm family (``paligemma-3b``: stub
patch embeddings through ``vision_proj`` prepended to the token embeddings,
a prefix-LM mask, MQA, tied embeddings) — init, batches, the analysis
sequence, the forward, the loss on the text positions only, the prefix
property, one trainer step and the serving refusals.

Reduced paligemma (2 layers, d 64, 4 query heads over one KV head, 8
patches of 32, vocab 256) is initialised by the JAX package under ``jit``;
the parameters cross as numpy arrays and both sides get the same
numpy-made patches and tokens.  f32: logits and losses within 1e-5
absolute; data bit for bit; shapes exactly.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core.pruner import analysis_seq as j_analysis_seq
from repro.configs import get_config as j_get_config, reduced as j_reduced
from repro.data.synthetic import batches as j_batches
from repro.serve.engine import Engine as JEngine
from repro.train.optim import OptConfig as JOptConfig
from repro.train.optim import adamw_update as j_adamw_update
from repro.train.optim import init_opt_state as j_init_opt_state
from repro_torch.configs import get_config, reduced
from repro_torch.core.graph import tree_map_paths, tree_paths
from repro_torch.core.pruner import analysis_seq
from repro_torch.data import synthetic
from repro_torch.data.synthetic import batches
from repro_torch.models import attention
from repro_torch.models import build as t_build
from repro_torch.train.compress import init_error_state
from repro_torch.train.loop import TrainerConfig, make_grad_step
from repro_torch.train.optim import OptConfig, init_opt_state
from test_torch_encoder import (ATOL, NEW_FAMILIES, J, T,
                                _close_to_leaf_scale, models)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

NAME = "paligemma-3b"


def vlm_batch(cfg, B: int = 2, text: int = 7, seed: int = 0) -> dict:
    """Numpy patches (B, vision_tokens, vision_embed_dim) and tokens (B,
    text)."""
    rng = np.random.default_rng(seed)
    return {"patches": rng.standard_normal(
                (B, cfg.vision_tokens, cfg.vision_embed_dim)
            ).astype(np.float32),
            "tokens": rng.integers(0, cfg.vocab_size,
                                   (B, text)).astype(np.int32)}


def test_init_paths_shapes_and_count_match_jax():
    """``vision_proj`` (vision_embed_dim, d) beside ``tok_embed``, no
    ``head`` (tied embeddings), MQA's one KV head; as many parameters as
    the config counts."""
    jm, jp, tm, _ = models(NAME)
    ref = {p: (tuple(x.shape), str(x.dtype)) for p, x in tree_paths(jp)}
    tp = tm.init(seed=0, device="cpu")
    got = {p: (tuple(x.shape), str(x.dtype).replace("torch.", ""))
           for p, x in tree_paths(tp)}
    assert got == ref
    c = tm.cfg
    assert got["vision_proj"][0] == (c.vision_embed_dim, c.d_model)
    assert got["layers.attn.wk"][0] == (c.num_layers, c.d_model, 1,
                                        c.head_dim_)
    assert "head" not in got and "frame_proj" not in got
    assert sum(x.numel() for _, x in tree_paths(tp)) == c.param_count()


@pytest.mark.parametrize("mode", ["id", "ood", "datafree", "eval"])
def test_vlm_batches_equal_the_reference_bit_for_bit(mode):
    """Tokens drawn (Markov task or DataFree) at the full length, then the
    patches, then the tokens cut to ``max(seq - vision_tokens, 4)``."""
    cfg = models(NAME)[2].cfg
    for seq in (cfg.vision_tokens + 6, 5):
        ref = j_batches(cfg, mode, 2, 3, seq, seed=11, task_seed=2)
        got = batches(cfg, mode, 2, 3, seq, seed=11, task_seed=2,
                      device="cpu")
        for r, g in zip(ref, got):
            assert g.keys() == {"patches", "tokens"}
            assert g["patches"].dtype == torch.float32
            assert g["tokens"].dtype == torch.int32
            assert tuple(g["tokens"].shape) == \
                (3, max(seq - cfg.vision_tokens, 4))
            for k in g:
                np.testing.assert_array_equal(g[k].numpy(),
                                              np.asarray(r[k]))


def test_datafree_vlm_batches_never_build_the_task(monkeypatch):
    """At paligemma's vocab of 257216 the Markov task's matrix is 529 GB:
    DataFree batches must not build it (the reference's would)."""
    def refuse(*a, **kw):
        raise AssertionError("the Markov task was built")
    monkeypatch.setattr(synthetic, "MarkovLM", refuse)
    cfg = get_config(NAME)
    b = batches(cfg, "datafree", 1, 1, cfg.vision_tokens + 4, seed=3,
                device="cpu")[0]
    assert tuple(b["patches"].shape) == (1, 256, 1152)
    assert tuple(b["tokens"].shape) == (1, 4)
    assert int(b["tokens"].max()) < cfg.vocab_size


def test_dummy_batch_and_analysis_seq_match_the_reference(key):
    """The trace sees 8 text tokens after the image prefix: the
    reference's ``analysis_seq`` rule for the vlm family, at every new
    config and its reduced form; the dummy batch's shapes as the
    reference's."""
    for name in NEW_FAMILIES:
        for cfg in (get_config(name), reduced(get_config(name))):
            assert analysis_seq(cfg) == j_analysis_seq(cfg)
    assert analysis_seq(get_config(NAME)) == 256 + 8
    jm, _, tm, _ = models(NAME)
    s = analysis_seq(tm.cfg)
    assert s == tm.cfg.vision_tokens + 8
    ref = jm.dummy_batch(key, 1, s, with_targets=False)
    got = tm.dummy_batch(1, s, device="cpu")
    assert {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in got.items()} == \
        {k: (tuple(v.shape), str(v.dtype)) for k, v in ref.items()}


def test_forward_and_text_loss_match_jax():
    """Logits at every position (image rows first) and the next-token CE
    on the text positions only."""
    jm, jp, tm, tp = models(NAME)
    c = tm.cfg
    b = vlm_batch(c, text=9, seed=4)
    ref = np.asarray(jm.forward(jp, J(b)))
    with torch.no_grad():
        got = tm.forward(tp, T(b))
        tl, _ = tm.loss(tp, T(b))
    assert tuple(got.shape) == (2, c.vision_tokens + 9, c.vocab_size)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=0)
    jl, _ = jm.loss(jp, J(b))
    assert abs(float(jl) - float(tl)) < ATOL
    text = torch.from_numpy(np.array(ref))[:, c.vision_tokens:]
    ce = torch.nn.functional.cross_entropy(
        text[:, :-1].reshape(-1, c.vocab_size),
        torch.from_numpy(b["tokens"][:, 1:]).reshape(-1).long())
    assert abs(float(ce) - float(tl)) < ATOL


def test_prefix_mask_property():
    """``tests/test_models.py::test_vlm_prefix_mask`` on the port: the last
    text token moves no logit before it; and image rows see every image
    row (flipping the last patch moves the first row), in both packages
    alike."""
    jm, jp, tm, tp = models(NAME)
    b = vlm_batch(tm.cfg, B=1, text=8, seed=5)
    b2 = dict(b, tokens=b["tokens"].copy())
    b2["tokens"][:, -1] = (b2["tokens"][:, -1] + 1) % tm.cfg.vocab_size
    b3 = dict(b, patches=b["patches"].copy())
    b3["patches"][:, -1] *= -1
    with torch.no_grad():
        base, l2, l3 = (tm.forward(tp, T(x)) for x in (b, b2, b3))
    np.testing.assert_allclose(l2[:, :-1].numpy(), base[:, :-1].numpy(),
                               atol=ATOL, rtol=0)
    assert float((l2[:, -1] - base[:, -1]).abs().max()) > 1e-3
    moved = (l3 - base)[:, 0]
    assert float(moved.abs().max()) > 1e-3
    ref = np.asarray(jm.forward(jp, J(b3)) - jm.forward(jp, J(b)))[:, 0]
    np.testing.assert_allclose(moved.numpy(), ref, atol=ATOL, rtol=0)


def test_prefix_attention_never_takes_the_kernel_route(monkeypatch):
    """As the reference's ``use_pallas`` branch: the prefix mask runs the
    plain attention even on the kernel route (``_on_kernel`` forced)."""
    _, _, tm, tp = models(NAME)
    calls = []
    monkeypatch.setattr(attention, "_on_kernel",
                        lambda cfg, x: cfg.use_kernels)
    monkeypatch.setattr(attention, "flash_attention",
                        lambda *a, **kw: calls.append(a))
    b = T(vlm_batch(tm.cfg, seed=6))
    with torch.no_grad():
        got = tm.forward(tp, b)
        plain = t_build(tm.cfg.replace(use_kernels=False)).forward(tp, b)
    assert calls == []
    assert torch.equal(got, plain)


def test_one_trainer_step_matches_jax():
    """The trainer's step on a DataFree vlm batch against the reference's
    loss gradient and AdamW update (``test_torch_encoder``'s limits)."""
    jm, jp, tm, tp = models(NAME)
    data = j_batches(jm.cfg, "datafree", 1, 3, jm.cfg.vision_tokens + 10,
                     seed=4)[0]
    oc = dict(lr=1e-3, warmup_steps=2, total_steps=20, grad_clip=0.5)
    (jloss, _), jg = jax.jit(jax.value_and_grad(
        lambda p: jm.loss(p, data), has_aux=True))(jp)
    jnew, jst, jom = j_adamw_update(jp, jg, j_init_opt_state(jp),
                                    JOptConfig(**oc))
    tp = tree_map_paths(lambda _, x: x.clone(), tp)
    st = init_opt_state(tp)
    step = make_grad_step(tm, OptConfig(**oc), TrainerConfig())
    new, st, _, om = step(tp, st, init_error_state(tp), T(data))
    assert float(om["loss"]) == pytest.approx(float(jloss), rel=1e-6)
    assert float(om["grad_norm"]) == pytest.approx(float(jom["grad_norm"]),
                                                   rel=1e-5)
    _close_to_leaf_scale(st["m"], jst["m"], 1e-5, "m")
    _close_to_leaf_scale(st["v"], jst["v"], 1e-5, "v")
    jnew_by = dict(tree_paths(jax.tree.map(np.asarray, jnew)))
    for path, t in tree_paths(new):
        np.testing.assert_allclose(t.numpy(), jnew_by[path], rtol=0,
                                   atol=0.1 * float(om["lr"]), err_msg=path)


def test_engine_and_serve_cli_refuse_vlm_with_the_reference_message():
    """The reference engine refuses the family before anything else; the
    port's engine and serving CLI say the same."""
    from repro_torch.launch import serve as cli
    from repro_torch.serve import Engine
    jm, jp, tm, tp = models(NAME)
    with pytest.raises(ValueError) as want:
        JEngine(jm, jp)
    with pytest.raises(ValueError) as got:
        Engine(tm, tp, device="cpu")
    assert str(got.value) == str(want.value) == \
        "vlm serving needs patch prefill (not supported)"
    with pytest.raises(ValueError, match="vlm serving needs patch prefill"):
        cli.main(["--arch", NAME, "--reduced", "--requests", "2",
                  "--device", "cpu"])
