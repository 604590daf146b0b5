"""PyTorch port vs JAX reference: the audio family — HuBERT-style encoders
(``hubert-xlarge``: a target per frame) and the paper's ``vit-mini`` and
``distilbert-mini`` (sequence classification from the mean hidden state)
— configs, init, ``layer_norm``, ``FrameTask`` and its batches, the
bidirectional forward, both encoder losses and one trainer step
(pruning: ``test_torch_encoder_prune.py``; the vlm family:
``test_torch_vlm.py``).

The reduced configs are initialised by the JAX package (under ``jit``);
the parameters cross as numpy arrays through ``repro_torch.convert`` and
both sides get the same numpy-made frames.  f32 throughout: logits and
losses within 1e-5 absolute, ``layer_norm`` within 1e-6; the data arrays
bit for bit; shapes and parameter counts exactly.  One AdamW step is held
as ``test_torch_cnn`` holds it (gradients, m and v within 1e-5 of each
leaf's largest value; parameters within 0.1·lr).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as j_get_config, reduced as j_reduced
from repro.data.synthetic import FrameTask as JFrameTask
from repro.data.synthetic import batches as j_batches
from repro.models import build as j_build
from repro.models import layers as j_layers
from repro.train.optim import OptConfig as JOptConfig
from repro.train.optim import adamw_update as j_adamw_update
from repro.train.optim import init_opt_state as j_init_opt_state
from repro_torch import convert
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import AUDIO_FRAME_DIM
from repro_torch.core.graph import tree_map_paths, tree_paths
from repro_torch.data.synthetic import FrameTask, batches
from repro_torch.models import attention
from repro_torch.models import build as t_build
from repro_torch.models import layers as t_layers
from repro_torch.models import transformer as tf
from repro_torch.train.compress import init_error_state
from repro_torch.train.loop import TrainerConfig, make_grad_step
from repro_torch.train.optim import OptConfig, init_opt_state

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ATOL = 1e-5
ARCHS = {"hubert": "hubert-xlarge", "vit": "vit-mini",
         "distilbert": "distilbert-mini"}
NEW_FAMILIES = ("hubert-xlarge", "paligemma-3b", "vit-mini",
                "distilbert-mini")
_MODELS: dict = {}


def models(arch: str):
    """(JAX model, JAX params, port model, port params) on shared weights,
    drawn by the JAX package's ``init`` under ``jit`` (reduced config)."""
    if arch not in _MODELS:
        name = ARCHS.get(arch, arch)
        jcfg = j_reduced(j_get_config(name))
        jm = j_build(jcfg)
        jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
        tm = t_build(convert.convert_config(dataclasses.asdict(jcfg)))
        tp = convert.convert_params(jax.tree.map(np.asarray, jp))
        _MODELS[arch] = (jm, jp, tm, tp)
    return _MODELS[arch]


def frames(cfg, B: int = 2, S: int = 12, seed: int = 0) -> dict:
    """Numpy frames (B, S, AUDIO_FRAME_DIM) and targets: (B,) classes for
    at most 16, else (B, S) per frame."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, AUDIO_FRAME_DIM)).astype(np.float32)
    shape = (B,) if cfg.vocab_size <= 16 else (B, S)
    y = rng.integers(0, cfg.vocab_size, shape).astype(np.int32)
    return {"frames": x, "targets": y}


def J(b: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in b.items()}


def T(b: dict) -> dict:
    return {k: torch.from_numpy(np.array(v)) for k, v in b.items()}


@pytest.mark.parametrize("shape", [(2, 5, 64), (3, 7, 4, 16)])
def test_layer_norm(shape):
    """The population variance in f32 (``jnp.var``), scale and bias."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(shape) * 3 + 1).astype(np.float32)
    w = rng.standard_normal(shape[-1]).astype(np.float32)
    b = rng.standard_normal(shape[-1]).astype(np.float32)
    ref = np.asarray(j_layers.layer_norm(jnp.asarray(x), jnp.asarray(w),
                                         jnp.asarray(b), 1e-5))
    got = t_layers.layer_norm(torch.from_numpy(x), torch.from_numpy(w),
                              torch.from_numpy(b), 1e-5)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6, rtol=0)


def test_layer_norm_bf16_statistics_in_f32():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, 64)).astype(np.float32)
    w, b = np.ones(64, np.float32), np.zeros(64, np.float32)
    ref = j_layers.layer_norm(jnp.asarray(x, jnp.bfloat16),
                              jnp.asarray(w, jnp.bfloat16),
                              jnp.asarray(b, jnp.bfloat16), 1e-5)
    got = t_layers.layer_norm(torch.from_numpy(x).bfloat16(),
                              torch.from_numpy(w).bfloat16(),
                              torch.from_numpy(b).bfloat16(), 1e-5)
    assert got.dtype == torch.bfloat16
    # both round the same f32 result to bf16 once
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               atol=0, rtol=2 ** -7)


@pytest.mark.parametrize("reduce", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("name", NEW_FAMILIES)
def test_configs_and_param_count_equal_the_reference(name, reduce):
    """Every field (``use_pallas`` / ``use_kernels`` aside) and the
    analytic parameter count, exactly; ``reduced`` keeps paligemma's
    single KV head and gives it 8 patches of 32."""
    jc, tc = j_get_config(name), get_config(name)
    if reduce:
        jc, tc = j_reduced(jc), reduced(tc)
    ref, got = dataclasses.asdict(jc), dataclasses.asdict(tc)
    ref.pop("use_pallas")
    got.pop("use_kernels")
    assert got == ref
    assert tc.param_count() == jc.param_count()
    assert tc.has_decode == jc.has_decode == (tc.family == "vlm")
    if reduce and tc.family == "vlm":
        assert (tc.n_kv_heads, tc.vision_tokens, tc.vision_embed_dim) == \
            (1, 8, 32)
    tf.require_ported(tc)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_init_paths_shapes_and_count_match_jax(arch):
    """``frame_proj`` (512, d) in place of ``tok_embed``, the untied
    ``head`` (d, classes or targets); the port's own init holds the
    reference's paths, shapes and dtypes, and as many parameters as the
    config counts."""
    jm, jp, tm, _ = models(arch)
    ref = {p: (tuple(x.shape), str(x.dtype)) for p, x in tree_paths(jp)}
    tp = tm.init(seed=0, device="cpu")
    got = {p: (tuple(x.shape), str(x.dtype).replace("torch.", ""))
           for p, x in tree_paths(tp)}
    assert got == ref
    d = tm.cfg.d_model
    assert got["frame_proj"][0] == (AUDIO_FRAME_DIM, d)
    assert got["head"][0] == (d, tm.cfg.vocab_size)
    assert "tok_embed" not in got
    assert sum(x.numel() for _, x in tree_paths(tp)) == tm.cfg.param_count()


@pytest.mark.parametrize("name", ["vit-mini", "distilbert-mini"])
def test_full_width_minis_init_like_jax(name):
    """The paper's encoders at their registered size (6 layers, d 256):
    paths and shapes as ``jax.eval_shape`` of the reference's init, and the
    config's count held."""
    jm = j_build(j_get_config(name))
    ref = {p: tuple(x.shape) for p, x in tree_paths(
        jax.eval_shape(jm.init, jax.random.PRNGKey(0)))}
    tp = t_build(get_config(name)).init(seed=0, device="cpu")
    assert {p: tuple(x.shape) for p, x in tree_paths(tp)} == ref
    assert sum(x.numel() for _, x in tree_paths(tp)) == \
        get_config(name).param_count()


@pytest.mark.parametrize("mode", ["id", "ood", "datafree", "eval"])
def test_frame_batches_equal_the_reference_bit_for_bit(mode):
    """``FrameTask``'s quantile buckets (per frame for HuBERT's 256
    reduced targets, the pooled label for vit's 10 and distilbert's 2
    classes) and the DataFree frames and targets, from the same seeds."""
    for arch in sorted(ARCHS):
        cfg = models(arch)[2].cfg
        ref = j_batches(cfg, mode, 2, 3, 10, seed=11, task_seed=2)
        got = batches(cfg, mode, 2, 3, 10, seed=11, task_seed=2,
                      device="cpu")
        for r, g in zip(ref, got):
            assert g.keys() == {"frames", "targets"}
            assert g["frames"].dtype == torch.float32
            assert g["targets"].dtype == torch.int32
            want = (3,) if cfg.vocab_size <= 16 else (3, 10)
            assert tuple(g["targets"].shape) == want
            for k in g:
                np.testing.assert_array_equal(g[k].numpy(),
                                              np.asarray(r[k]))
        if mode == "datafree":
            x = got[0]["frames"]
            assert float(x.min()) >= -1.0 and float(x.max()) < 1.0
    for vocab in (2, 504):
        j, t = JFrameTask(vocab, seed=5), FrameTask(vocab, seed=5)
        np.testing.assert_array_equal(t.proj, j.proj)
        a = j.sample(np.random.default_rng(3), 4, 16)
        b = t.sample(np.random.default_rng(3), 4, 16)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(y, x)


def test_dummy_batch_shapes_match_the_reference(key):
    """The reference's dummy batch shapes and dtypes (values: the port
    draws with numpy)."""
    for arch in sorted(ARCHS):
        jm, _, tm, _ = models(arch)
        ref = jm.dummy_batch(key, 2, 9)
        got = tm.dummy_batch(2, 9, device="cpu")
        assert {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
                for k, v in got.items()} == \
            {k: (tuple(v.shape), str(v.dtype)) for k, v in ref.items()}


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_forward_and_loss_match_jax(arch):
    """Per-frame logits (B, S, V) and the loss: per-frame CE for HuBERT's
    256 targets, CE of ``mean(h) @ head`` for the classifiers."""
    jm, jp, tm, tp = models(arch)
    b = frames(jm.cfg, S=13, seed=4)
    ref = np.asarray(jm.forward(jp, J(b)))
    with torch.no_grad():
        got = tm.forward(tp, T(b))
        tl, parts = tm.loss(tp, T(b))
    assert tuple(got.shape) == (2, 13, jm.cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=0)
    jl, _ = jm.loss(jp, J(b))
    assert abs(float(jl) - float(tl)) < ATOL
    assert float(parts["aux"]) == 0.0
    if jm.cfg.vocab_size <= 16:
        # the classifier on the mean hidden state is the mean of the
        # per-frame logits (the head is linear)
        pooled = torch.from_numpy(np.array(ref)).mean(dim=1)
        ce = torch.nn.functional.cross_entropy(
            pooled, torch.from_numpy(b["targets"]).long())
        assert abs(float(ce) - float(tl)) < ATOL


def test_encoders_attend_both_ways():
    """A change of the last frame moves the first frame's logits (a causal
    model could not), in both packages alike."""
    jm, jp, tm, tp = models("hubert")
    b = frames(jm.cfg, B=1, S=9, seed=6)
    b2 = dict(b, frames=b["frames"].copy())
    b2["frames"][:, -1] *= -1
    with torch.no_grad():
        moved = (tm.forward(tp, T(b2)) - tm.forward(tp, T(b)))[:, 0]
    ref = np.asarray(jm.forward(jp, J(b2)) - jm.forward(jp, J(b)))[:, 0]
    assert float(moved.abs().max()) > 1e-3
    np.testing.assert_allclose(moved.numpy(), ref, atol=ATOL, rtol=0)


def test_bidirectional_attention_takes_the_kernel_route(monkeypatch):
    """On the kernel route (CUDA tensors; here ``_on_kernel`` forced) every
    layer's attention goes to flash attention (K2) with ``causal=False``,
    and gives the plain forward's logits."""
    jm, jp, tm, tp = models("vit")
    b = T(frames(jm.cfg, S=11, seed=7))
    with torch.no_grad():
        plain = t_build(tm.cfg.replace(use_kernels=False)).forward(tp, b)
    calls = []
    real = attention.flash_attention

    def spy(q, k, v, *, causal=True, window=0):
        calls.append((causal, window, tuple(q.shape), tuple(v.shape)))
        return real(q, k, v, causal=causal, window=window)

    monkeypatch.setattr(attention, "_on_kernel",
                        lambda cfg, x: cfg.use_kernels)
    monkeypatch.setattr(attention, "flash_attention", spy)
    with torch.no_grad():
        got = tm.forward(tp, b)
    c = tm.cfg
    assert calls == [(False, 0, (2, 11, c.n_heads, c.head_dim_),
                      (2, 11, c.n_kv_heads, c.v_head_dim_))] * c.num_layers
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=ATOL,
                               rtol=0)


def _close_to_leaf_scale(got, want, rel, name):
    want_by = dict(tree_paths(jax.tree.map(np.asarray, want)))
    for path, t in tree_paths(got):
        w = want_by[path]
        np.testing.assert_allclose(t.numpy(), w, rtol=0,
                                   atol=rel * float(np.abs(w).max()),
                                   err_msg=f"{name} {path}")


def test_one_trainer_step_matches_jax():
    """The trainer's step (``make_grad_step``) on a ``FrameTask`` batch of
    reduced vit-mini against the reference's loss gradient and AdamW
    update: the loss, the gradient norm (clipping on), m, v and the new
    parameters."""
    jm, jp, tm, tp = models("vit")
    data = j_batches(jm.cfg, "id", 1, 4, 12, seed=4)[0]
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


def test_cli_trains_and_prunes_an_encoder(capsys):
    from repro_torch.launch import train as cli
    cli.main(["--arch", "vit-mini", "--reduced", "--steps", "4", "--batch",
              "4", "--seq", "16", "--prune-ratio", "0.5", "--prune-at", "2",
              "--device", "cpu"])
    out = capsys.readouterr().out
    assert "pruned: d_ff 128->64, heads 4->2" in out
    assert "loss:" in out


def test_serve_cli_and_engine_refuse_encoders():
    """As the reference's CLI and engine: an encoder has no decode path."""
    from repro_torch.launch import serve as cli
    from repro_torch.serve import Engine
    with pytest.raises(SystemExit, match="encoder-only; no decode path"):
        cli.main(["--arch", "hubert-xlarge", "--reduced", "--device", "cpu"])
    _, _, tm, tp = models("hubert")
    with pytest.raises(ValueError, match="has no decode path"):
        Engine(tm, tp, device="cpu")


def test_encoder_entry_points_need_a_device_or_the_cpu_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = models("hubert")[2].cfg
    for fn in (lambda: t_build(cfg).init(seed=0),
               lambda: batches(cfg, "id", 1, 2, 4),
               lambda: t_build(cfg).dummy_batch(1, 4)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn()


@pytest.mark.gpu
def test_k2_bidirectional_at_hubert_width_on_the_card():
    """K2 at hubert-xlarge's head shape (16 heads of 80, bidirectional,
    bf16, 200 frames: not a multiple of the 64-row tile) against its plain
    version: one bf16 step of the value, plus 2e-4 near zero."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    from repro_torch.kernels.flash_attention import (flash_attention_kernel,
                                                      flash_attention_ref)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    q, k, v = (torch.randn((2, 200, 16, 80), generator=gen,
                           device="cuda").bfloat16() for _ in range(3))
    out = flash_attention_kernel(q, k, v, causal=False)
    ref = flash_attention_ref(q, k, v, causal=False)
    err = (out.float() - ref.float()).abs()
    assert float((err - (2e-4 + 2 ** -7 * ref.float().abs())).max()) <= 0
