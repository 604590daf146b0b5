"""PyTorch port vs JAX reference: configs, shared layers, weight conversion.

Inputs are made from a seed with numpy and handed to both sides.  f32
throughout; tolerance 1e-5 absolute unless a test says otherwise.  TF32 is
switched off (it only matters on a GPU, but the port's tests state it).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import base as jbase
from repro.models import layers as jlayers
from repro_torch import convert
from repro_torch.configs import base as tbase
from repro_torch.models import layers as tlayers

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ATOL = 1e-5
LM_ARCHS = sorted(jbase.ASSIGNED_ARCHS)


def _as_dict(cfg):
    d = dataclasses.asdict(cfg)
    d.pop("use_pallas", None)
    d.pop("use_kernels", None)
    return d


@pytest.mark.parametrize("reduce", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("name", LM_ARCHS)
def test_config_equals_reference(name, reduce):
    jc, tc = jbase.get_config(name), tbase.get_config(name)
    if reduce:
        jc, tc = jbase.reduced(jc), tbase.reduced(tc)
    assert _as_dict(jc) == _as_dict(tc)
    for prop in ("head_dim_", "v_head_dim_", "q_per_kv", "d_inner",
                 "ssm_n_heads", "has_decode", "sub_quadratic"):
        assert getattr(jc, prop) == getattr(tc, prop), prop
    # the reference leaves out the SSD block's dt_bias (nh) and norm
    # (d_inner) and counts an ssm layer's one RMSNorm twice; the port
    # counts the tensors it holds
    missed = 0
    if tc.ssm_state:
        missed = tc.num_layers * (tc.ssm_n_heads + tc.d_inner)
        if tc.family == "ssm":
            missed -= tc.num_layers * tc.d_model
    assert jc.param_count() + missed == tc.param_count()
    assert jc.active_param_count() + missed == tc.active_param_count()
    assert tc.use_kernels is True


def test_registry_and_shapes_match():
    assert tuple(tbase.ASSIGNED_ARCHS) == tuple(jbase.ASSIGNED_ARCHS)
    assert set(tbase.list_archs()) == set(jbase.list_archs())
    assert {k: dataclasses.asdict(v) for k, v in tbase.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jbase.SHAPES.items()}
    with pytest.raises(KeyError):
        tbase.get_config("no-such-arch")


def test_convert_config_roundtrip_of_a_pruned_shape():
    jc = jbase.reduced(jbase.get_config("tinyllama-1.1b")).replace(
        head_dim=24, v_head_dim=40, d_ff=72, global_layers=(0, 1))
    tc = convert.convert_config(dataclasses.asdict(jc))
    assert _as_dict(tc) == _as_dict(jc)
    assert tc.global_layers == (0, 1) and tc.use_kernels
    with pytest.raises(KeyError):
        convert.convert_config({"name": "x", "family": "dense", "bogus": 1})


@pytest.mark.parametrize("shape", [(2, 5, 64), (3, 7, 4, 16)])
def test_rms_norm(shape):
    rng = np.random.default_rng(0)
    x = rng.standard_normal(shape).astype(np.float32)
    w = rng.standard_normal(shape[-1]).astype(np.float32)
    ref = np.asarray(jlayers.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6))
    got = tlayers.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=0)


def test_rms_norm_bf16_statistics_in_f32():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, 64)).astype(np.float32)
    w = np.ones(64, np.float32)
    ref = jlayers.rms_norm(jnp.asarray(x, jnp.bfloat16),
                           jnp.asarray(w, jnp.bfloat16), 1e-6)
    got = tlayers.rms_norm(torch.from_numpy(x).bfloat16(),
                           torch.from_numpy(w).bfloat16(), 1e-6)
    assert got.dtype == torch.bfloat16
    # both round the same f32 result to bf16 once: at most one bf16 ulp apart
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               atol=0, rtol=2 ** -7)


@pytest.mark.parametrize("hd", [16, 24, 64])
def test_apply_rope(hd):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 6, 3, hd)).astype(np.float32)
    pos = rng.integers(0, 500, size=(2, 6)).astype(np.int32)
    np.testing.assert_array_equal(tlayers.rope_freqs(hd, 1e4),
                                  jlayers.rope_freqs(hd, 1e4))
    ref = np.asarray(jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                        10_000.0))
    got = tlayers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                             10_000.0)
    # sin/cos of angles up to 500 rad in f32 differ in the last bits
    np.testing.assert_allclose(got.numpy(), ref, atol=5e-5, rtol=0)


def test_swiglu():
    rng = np.random.default_rng(3)
    p = {"w_gate": rng.standard_normal((32, 48)).astype(np.float32) / 6,
         "w_up": rng.standard_normal((32, 48)).astype(np.float32) / 6,
         "w_down": rng.standard_normal((48, 32)).astype(np.float32) / 7}
    x = rng.standard_normal((2, 5, 32)).astype(np.float32)
    ref = np.asarray(jlayers.swiglu(jax.tree.map(jnp.asarray, p),
                                    jnp.asarray(x)))
    got = tlayers.swiglu(convert.convert_params(p), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy(masked):
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((3, 7, 50)).astype(np.float32) * 3
    tgt = rng.integers(0, 50, size=(3, 7)).astype(np.int32)
    mask = (rng.random((3, 7)) > 0.4) if masked else None
    ref = float(jlayers.cross_entropy(
        jnp.asarray(logits), jnp.asarray(tgt),
        None if mask is None else jnp.asarray(mask)))
    got = float(tlayers.cross_entropy(
        torch.from_numpy(logits), torch.from_numpy(tgt),
        None if mask is None else torch.from_numpy(mask)))
    assert abs(got - ref) < ATOL


def test_init_helpers_are_seeded_and_scaled():
    g = torch.Generator(device="cpu").manual_seed(7)
    a = tlayers.dense_init(g, (256, 8, 16), torch.float32)
    g.manual_seed(7)
    b = tlayers.dense_init(g, (256, 8, 16), torch.float32)
    assert torch.equal(a, b)
    assert abs(float(a.std()) - 1 / 16) < 5e-3          # 1/sqrt(fan_in=256)
    e = tlayers.embed_init(g, (512, 64), torch.bfloat16)
    assert e.dtype == torch.bfloat16 and abs(float(e.float().std()) - 0.02) \
        < 2e-3
    assert tlayers.dtype_of("bfloat16") is torch.bfloat16


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8", "int32",
                                   "float8_e4m3fn"])
def test_convert_roundtrip_bitwise(dtype):
    """JAX array -> numpy -> tensor keeps every bit (bf16/fp8 go through an
    integer view) and owns its memory."""
    rng = np.random.default_rng(5)
    x = jnp.asarray(rng.standard_normal((5, 3, 8)) * 20).astype(dtype)
    arr = np.asarray(x)                      # read-only buffer from JAX
    t = convert.to_tensor(arr)
    assert str(t.dtype).replace("torch.", "") == dtype
    width = {1: np.uint8, 2: np.uint16, 4: np.uint32}[arr.dtype.itemsize]
    np.testing.assert_array_equal(convert.to_numpy(t).view(width),
                                  arr.view(width))
    np.testing.assert_allclose(t.float().numpy(),
                               np.asarray(x.astype(jnp.float32)), atol=0)
    t.zero_()                                # writable: it is a copy
    assert float(jnp.abs(x.astype(jnp.float32)).sum()) > 0


def test_convert_params_keeps_paths_and_layouts():
    from repro.models import build as jbuild
    cfg = jbase.reduced(jbase.get_config("qwen3-1.7b"))
    jp = jbuild(cfg).init(jax.random.PRNGKey(0))
    tp = convert.convert_params(jax.tree.map(np.asarray, jp))
    jl = {jax.tree_util.keystr(k): v
          for k, v in jax.tree_util.tree_leaves_with_path(jp)}

    def walk(tree, path=""):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from walk(v, f"{path}['{k}']")
        else:
            yield path, tree
    tl = dict(walk(tp))
    assert set(tl) == set(jl)
    for k in jl:
        assert tuple(tl[k].shape) == tuple(jl[k].shape), k
        np.testing.assert_array_equal(tl[k].numpy(), np.asarray(jl[k]))
    L, H, hd = cfg.num_layers, cfg.n_heads, cfg.head_dim_
    assert tuple(tp["layers"]["attn"]["wq"].shape) == (L, cfg.d_model, H, hd)
    assert tuple(tp["layers"]["attn"]["wo"].shape) == (L, H, hd, cfg.d_model)
