"""PyTorch port vs JAX reference: the cnn family (the paper's own ResNet and
VGG at CIFAR scale) — configs, init, the forward in both BatchNorm modes,
``PrototypeImages`` and one trainer step (pruning:
``test_torch_cnn_prune.py``; OBSPA: ``test_torch_cnn_obspa.py``).

Reduced ``resnet18-cifar`` (stem 8, stages 8/8/16/32 of two basic blocks,
stride-2 blocks with 1x1 projections, 32 px) and reduced ``vgg19-cifar``
(five stages of two convs, 8–32 channels, max-pools, 100 classes, 64 px)
are initialised by the JAX package; the parameters cross as numpy arrays
through ``repro_torch.convert``, and both sides get the same numpy-made
images.  Reduced ``resnet50-cifar`` is the same model as reduced
``resnet18-cifar`` (``reduced`` keeps at most two blocks a stage), so the
full-width resnet50 runs on the card only; here its config and its init's
paths and shapes are held to the reference's at full width.

The BatchNorm leaves are redrawn away from their init (scale, bias, running
mean and variance), so that the eval-mode normalisation is not the
identity.  Tolerances (f32): logits and BN statistics within 1e-5 of the
largest reference value; one AdamW step as ``test_torch_train``'s (grads,
m, v within 1e-5 of each leaf's largest value; parameters within 0.1·lr).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as j_get_config, reduced as j_reduced
from repro.data.synthetic import batches as j_batches
from repro.models import build as j_build
from repro.models import cnn as j_cnn
from repro.train.optim import OptConfig as JOptConfig
from repro.train.optim import adamw_update as j_adamw_update
from repro.train.optim import init_opt_state as j_init_opt_state
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.core.graph import tree_map_paths, tree_paths
from repro_torch.data.synthetic import PrototypeImages, batches
from repro_torch.models import build as t_build
from repro_torch.models import cnn as t_cnn
from repro_torch.train.loop import TrainerConfig, make_grad_step
from repro_torch.train.compress import init_error_state
from repro_torch.train.optim import OptConfig, init_opt_state

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

RTOL = 1e-5
ARCHS = {"resnet18": "resnet18-cifar", "vgg19": "vgg19-cifar"}
PAPER = ("resnet18-cifar", "resnet50-cifar", "vgg19-cifar", "vit-mini",
         "distilbert-mini")
_MODELS: dict = {}


@pytest.fixture(autouse=True)
def one_thread():
    """Many small convolutions: one intra-op thread under the test
    workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _redraw_bn(jp, seed: int = 3):
    """The JAX tree with every BatchNorm leaf redrawn with numpy: scale in
    [0.5, 1.5), bias and running mean N(0, 0.1²), running variance in
    [0.5, 1.5)."""
    rng = np.random.default_rng(seed)
    draw = {"scale": lambda n: rng.uniform(0.5, 1.5, n),
            "bias": lambda n: rng.normal(0, 0.1, n),
            "mean": lambda n: rng.normal(0, 0.1, n),
            "var": lambda n: rng.uniform(0.5, 1.5, n)}

    def leaf(path, x):
        name = str(path[-1].key)
        if name in draw and x.ndim == 1:
            return jnp.asarray(draw[name](x.shape[0]).astype(np.float32))
        return x
    return jax.tree_util.tree_map_with_path(leaf, jp)


def models(arch: str = "resnet18"):
    """(JAX model, JAX params, port model, port params) on shared weights,
    drawn by the JAX package's ``init`` under ``jit``, BN leaves redrawn."""
    if arch not in _MODELS:
        jcfg = j_reduced(j_get_config(ARCHS[arch]))
        jm = j_build(jcfg)
        jp = _redraw_bn(jax.jit(jm.init)(jax.random.PRNGKey(0)))
        tm = t_build(convert.convert_config(dataclasses.asdict(jcfg)))
        tp = convert.convert_params(jax.tree.map(np.asarray, jp))
        _MODELS[arch] = (jm, jp, tm, tp)
    return _MODELS[arch]


def images(cfg, n: int = 4, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(
        (n, cfg.image_size, cfg.image_size, 3)).astype(np.float32)


def close_rel(got, ref, rtol=RTOL, what=""):
    """|got - ref| <= rtol · max|ref|."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=rtol * float(np.abs(ref).max()),
                               err_msg=what)


@pytest.mark.parametrize("name", PAPER)
def test_configs_equal_the_reference(name):
    """Every field of the port's copy of ``configs/paper_models.py`` equals
    the reference's (``use_pallas`` / ``use_kernels`` aside); the encoders
    build as the audio family (``tests/test_torch_encoder.py``)."""
    ref = dataclasses.asdict(j_get_config(name))
    ref.pop("use_pallas")
    got = dataclasses.asdict(get_config(name))
    got.pop("use_kernels")
    assert got == ref
    if j_get_config(name).family != "cnn":
        assert t_build(get_config(name)).cfg.is_encoder


@pytest.mark.parametrize("name,n_params", [("resnet18-cifar", None),
                                           ("resnet50-cifar", 21_282_112),
                                           ("vgg19-cifar", 20_081_088)])
def test_init_paths_and_shapes_match_jax_at_full_width(name, n_params):
    jm = j_build(j_get_config(name))
    ref = {p: tuple(x.shape) for p, x in tree_paths(
        jax.eval_shape(jm.init, jax.random.PRNGKey(0)))}
    tp = t_build(get_config(name)).init(seed=0, device="cpu")
    got = {p: tuple(x.shape) for p, x in tree_paths(tp)}
    assert got == ref
    assert all(x.dtype == torch.float32 for _, x in tree_paths(tp))
    if n_params is not None:
        assert sum(int(np.prod(s)) for p, s in got.items()
                   if p.startswith("params.")) == n_params


def test_same_padding_is_asymmetric_at_stride_two():
    assert t_cnn.same_pads(32, 3, 2) == (0, 1)
    assert t_cnn.same_pads(32, 3, 1) == (1, 1)
    assert t_cnn.same_pads(32, 1, 2) == (0, 0)
    assert t_cnn.same_pads(31, 3, 2) == (1, 1)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_eval_forward_matches_jax(arch):
    """Logits on converted weights, through every stride-2 block (whose
    asymmetric "SAME" padding a symmetric one would miss by O(1))."""
    jm, jp, tm, tp = models(arch)
    x = images(jm.cfg)
    ref = np.asarray(jm.forward(jp, {"images": jnp.asarray(x)}))
    with torch.no_grad():
        got = tm.forward(tp, {"images": torch.from_numpy(x)})
    assert got.shape == (4, jm.cfg.num_classes)
    close_rel(got, ref)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_train_mode_batchnorm_matches_jax(arch):
    """One ``train=True`` pass: the logits and the new running mean and var
    of every BN (biased batch variance, ``0.9·old + 0.1·new``)."""
    jm, jp, tm, tp = models(arch)
    x = images(jm.cfg, seed=1)
    jl, js = j_cnn.cnn_forward(jm.cfg, jp["params"], jp["state"],
                               jnp.asarray(x), train=True)
    with torch.no_grad():
        tl, ts = t_cnn.cnn_forward(tm.cfg, tp["params"], tp["state"],
                                   torch.from_numpy(x), train=True)
    close_rel(tl, jl, what="logits")
    ref = dict(tree_paths(jax.tree.map(np.asarray, js)))
    got = dict(tree_paths(ts))
    assert got.keys() == ref.keys()
    for path in ref:
        close_rel(got[path], ref[path], what=path)


def test_batchnorm_update_is_biased_and_explicit():
    """``_bn(train=True)`` on 16 values a channel equals the reference's:
    normalised by the biased variance, running var updated with it; the
    unbiased variance (``torch.var``'s default, and ``F.batch_norm``'s
    running update) is 16/15 of it, far outside the tolerance."""
    x = np.random.default_rng(2).standard_normal((4, 2, 2, 3)).astype(
        np.float32)
    p = {"scale": np.float32([1.0, 2.0, 0.5]),
         "bias": np.float32([0.0, 0.1, -0.1])}
    s = {"mean": np.float32([0.1, 0.0, -0.2]),
         "var": np.float32([1.0, 0.5, 2.0])}
    jy, js = j_cnn._bn(jnp.asarray(x), jax.tree.map(jnp.asarray, p),
                       jax.tree.map(jnp.asarray, s), train=True)
    T = lambda d: {k: torch.from_numpy(v) for k, v in d.items()}  # noqa
    ty, ts = t_cnn._bn(torch.from_numpy(x), T(p), T(s), train=True)
    close_rel(ty, jy)
    for k in ("mean", "var"):
        close_rel(ts[k], js[k], what=k)
    unbiased = 0.9 * s["var"] + 0.1 * x.reshape(-1, 3).var(0, ddof=1)
    assert np.abs(unbiased - np.asarray(js["var"])).min() > \
        100 * RTOL * np.abs(np.asarray(js["var"])).max()


@pytest.mark.parametrize("mode", ["id", "ood", "datafree", "eval"])
def test_prototype_batches_equal_the_reference_bit_for_bit(mode):
    for arch in sorted(ARCHS):
        cfg = models(arch)[2].cfg
        ref = j_batches(cfg, mode, 2, 5, 0, seed=11, task_seed=2)
        got = batches(cfg, mode, 2, 5, 0, seed=11, task_seed=2,
                      device="cpu")
        for r, g in zip(ref, got):
            assert g.keys() == {"images", "labels"}
            assert g["images"].dtype == torch.float32
            assert g["labels"].dtype == torch.int32
            np.testing.assert_array_equal(g["images"].numpy(),
                                          np.asarray(r["images"]))
            np.testing.assert_array_equal(g["labels"].numpy(),
                                          np.asarray(r["labels"]))
        if mode == "datafree":
            x = got[0]["images"]
            assert float(x.min()) >= -1.0 and float(x.max()) < 1.0
    task = PrototypeImages(10, 32, seed=5)
    assert task.protos.shape == (10, 32, 32, 3)


def _close_to_leaf_scale(got, want, rel, name):
    want_by = dict(tree_paths(jax.tree.map(np.asarray, want)))
    for path, t in tree_paths(got):
        w = want_by[path]
        np.testing.assert_allclose(t.numpy(), w, rtol=0,
                                   atol=rel * float(np.abs(w).max()),
                                   err_msg=f"{name} {path}")


def test_one_trainer_step_matches_jax():
    """The trainer's step (``make_grad_step``) on reduced resnet18 against
    the reference's loss gradient and AdamW update: the loss, the
    gradients of every leaf — the BN running mean and var too, which the
    eval-mode loss reaches and the reference trains — and the new
    parameters, m and v."""
    jm, jp, tm, tp = models("resnet18")
    data = j_batches(jm.cfg, "id", 1, 8, 0, seed=4)[0]
    oc = dict(lr=1e-3, warmup_steps=2, total_steps=20, grad_clip=0.5)
    (jloss, _), jg = jax.jit(jax.value_and_grad(
        lambda p: jm.loss(p, data), has_aux=True))(jp)
    jnew, jst, jom = j_adamw_update(jp, jg, j_init_opt_state(jp),
                                    JOptConfig(**oc))
    tp = tree_map_paths(lambda _, x: x.clone(), tp)
    tb = {k: torch.from_numpy(np.array(v)) for k, v in data.items()}
    st = init_opt_state(tp)
    step = make_grad_step(tm, OptConfig(**oc), TrainerConfig())
    new, st, _, om = step(tp, st, init_error_state(tp), tb)
    assert float(om["loss"]) == pytest.approx(float(jloss), rel=1e-6)
    assert float(om["grad_norm"]) > oc["grad_clip"]       # clipping is on
    assert float(om["grad_norm"]) == pytest.approx(float(jom["grad_norm"]),
                                                   rel=1e-5)
    assert float(np.abs(np.asarray(jg["state"]["s3b1"]["bn2"]["var"])
                        ).max()) > 0          # the statistics get gradients
    _close_to_leaf_scale(st["m"], jst["m"], 1e-5, "m")
    _close_to_leaf_scale(st["v"], jst["v"], 1e-5, "v")
    jnew_by = dict(tree_paths(jax.tree.map(np.asarray, jnew)))
    for path, t in tree_paths(new):
        np.testing.assert_allclose(t.numpy(), jnew_by[path], rtol=0,
                                   atol=0.1 * float(om["lr"]), err_msg=path)


def test_cli_trains_prunes_and_prints_the_kept_channels(capsys):
    from repro_torch.launch import train as cli
    cli.main(["--arch", "resnet18-cifar", "--reduced", "--steps", "4",
              "--batch", "4", "--prune-ratio", "0.5", "--prune-at", "2",
              "--device", "cpu"])
    out = capsys.readouterr().out
    line = [ln for ln in out.splitlines() if ln.startswith("pruned")][0]
    assert line.startswith("pruned (global): channels a stage [8, 8, 16, 32]"
                           " -> kept [[")
    assert "loss:" in out


def test_cnn_entry_points_need_a_device_or_the_cpu_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = models("resnet18")[2].cfg
    for fn in (lambda: t_build(cfg).init(seed=0),
               lambda: batches(cfg, "id", 1, 2, 0),
               lambda: t_build(cfg).dummy_batch(1, 0)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn()
