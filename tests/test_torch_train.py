"""PyTorch port of the training runtime, on the CPU: its own tests (mirrors of
``tests/test_train.py``) and its agreement with the JAX package.

Against the JAX package, on converted reduced-TinyLlama weights in f32: one
AdamW step (loss, grads, updated params, m, v, lr and grad norm), checkpoints
written by either package and read by the other (their msgpack payloads are
byte-identical, and the port's msgpack encoder gives ``msgpack.packb``'s
bytes), RP exactly and RF within the elementwise share XLA counts, and the
model's loss with the flash-attention branch against the reference's
``use_pallas=True`` loss (``test_model_pallas_parity``'s |Δ| < 1e-3).
Failure injection resumes bitwise-identically here; on the card the same
drill is held to a tolerance (``chip_smoke.py`` phase 11), since CUDA's
embedding backward is not deterministic.
"""
import dataclasses
import os
import sys

import msgpack as real_msgpack
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as j_get_config, reduced as j_reduced
from repro.core.flops import rf_rp as j_rf_rp
from repro.core.pruner import prune_model as j_prune_model
from repro.models import build as j_build
from repro.train import checkpoint as j_ckpt
from repro.train.optim import OptConfig as JOptConfig
from repro.train.optim import adamw_update as j_adamw_update
from repro.train.optim import init_opt_state as j_init_opt_state
from repro_torch import convert
from repro_torch.configs import get_config, reduced
from repro_torch.core.flops import param_count, rf_rp
from repro_torch.core.graph import tree_paths
from repro_torch.core.pruner import prune_model
from repro_torch.data.synthetic import batches
from repro_torch.models import attention as t_attention
from repro_torch.models import build
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import msgpack
from repro_torch.train.compress import (compress_grads, init_error_state,
                                        quantize_int8)
from repro_torch.train.loop import (SimulatedFailure, Trainer, TrainerConfig,
                                    make_grad_step, run_with_restarts)
from repro_torch.train.optim import (OptConfig, adamw_update, init_opt_state,
                                     lr_at, make_train_step, value_and_grad)

CPU = "cpu"


@pytest.fixture(scope="module")
def small_model():
    cfg = reduced(get_config("tinyllama-1.1b"))
    return cfg, build(cfg)


def _data_factory(cfg):
    def factory(start):
        def gen():
            i = start
            while True:
                yield batches(cfg, "id", 1, 8, 32, seed=5000 + i,
                              device=CPU)[0]
                i += 1
        return gen()
    return factory


def _leaves(tree):
    return [t for _, t in tree_paths(tree)]


def test_lr_schedule():
    oc = OptConfig(lr=1.0, warmup_steps=10, total_steps=100, min_lr_frac=0.1)
    step = lambda n: torch.tensor(n, dtype=torch.int32)  # noqa: E731
    assert float(lr_at(oc, step(0))) == 0.0
    assert abs(float(lr_at(oc, step(10))) - 1.0) < 1e-6
    assert float(lr_at(oc, step(100))) == pytest.approx(0.1, rel=1e-3)
    # the first update's lr is lr / warmup: ``step`` is incremented first
    p = {"w": torch.ones((2, 2))}
    _, st, om = adamw_update(p, {"w": torch.ones((2, 2))},
                             init_opt_state(p), oc)
    assert int(st["step"]) == 1 and float(om["lr"]) == pytest.approx(0.1)


def test_training_decreases_loss(small_model):
    cfg, m = small_model
    tc = TrainerConfig(total_steps=40, log_every=5)
    res = Trainer(m, OptConfig(lr=3e-3, warmup_steps=5, total_steps=40),
                  tc, CPU).train(_data_factory(cfg)(0))
    first, last = res.history[0]["loss"], res.history[-1]["loss"]
    assert last < first - 0.1, (first, last)


def test_trainer_needs_a_device_or_the_cpu_asked_for(small_model):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is the card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(small_model[1], OptConfig(), TrainerConfig())


def test_checkpoint_roundtrip(small_model, tmp_path):
    cfg, m = small_model
    params = m.init(0, CPU)
    opt = init_opt_state(params)
    p = ckpt.save_checkpoint(str(tmp_path / "step_00000007.ckpt"), 7,
                             {"params": params, "opt": opt})
    step, state, meta = ckpt.load_checkpoint(p, {"params": params,
                                                 "opt": opt})
    assert step == 7 and not meta["missing"] and not meta["extra"]
    for a, b in zip(_leaves(state), _leaves({"params": params, "opt": opt})):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_corrupt_checkpoint_skipped(small_model, tmp_path):
    cfg, m = small_model
    params = m.init(0, CPU)
    td = str(tmp_path)
    ckpt.save_checkpoint(ckpt.ckpt_path(td, 10), 10, {"p": params})
    path20 = ckpt.save_checkpoint(ckpt.ckpt_path(td, 20), 20, {"p": params})
    with open(path20, "r+b") as f:       # corrupt the newest
        f.seek(100)
        f.write(b"\x00" * 64)
    latest = ckpt.latest_checkpoint(td)
    assert latest is not None and "00000010" in latest


def test_prune_old_keeps_the_newest_and_milestones(small_model, tmp_path):
    td = str(tmp_path)
    for s in (5, 10, 15, 20, 25):
        ckpt.save_checkpoint(ckpt.ckpt_path(td, s), s,
                             {"x": torch.zeros(2)})
    ckpt.prune_old(td, keep=2, milestone_every=10)
    assert ckpt.checkpoint_steps(td) == [10, 20, 25]


def test_failure_injection_resume_identical(small_model, tmp_path):
    cfg, m = small_model
    oc = OptConfig(lr=1e-3, warmup_steps=5, total_steps=25)
    tc = TrainerConfig(total_steps=25, ckpt_dir=str(tmp_path / "a"),
                       ckpt_every=10, log_every=5, fail_at_step=13)
    res = run_with_restarts(m, oc, tc, _data_factory(cfg), device=CPU)
    assert res.resumed_from == 10
    tc2 = TrainerConfig(total_steps=25, ckpt_dir=str(tmp_path / "b"),
                        ckpt_every=10, log_every=5)
    res2 = Trainer(m, oc, tc2, CPU).train(_data_factory(cfg)(0))
    for a, b in zip(_leaves(res.params), _leaves(res2.params)):
        assert torch.equal(a, b)
    for a, b in zip(_leaves(res.opt_state), _leaves(res2.opt_state)):
        assert torch.equal(a, b)


def test_too_many_failures_raises(small_model, tmp_path):
    cfg, m = small_model
    tc = TrainerConfig(total_steps=10, ckpt_dir=str(tmp_path),
                       ckpt_every=100, fail_at_step=3)
    with pytest.raises(SimulatedFailure):
        # no checkpoint before step 3 -> every restart refails
        run_with_restarts(m, OptConfig(), tc, _data_factory(cfg),
                          max_failures=0, device=CPU)


def test_grad_compression_error_feedback(small_model):
    cfg, m = small_model
    params = m.init(0, CPU)
    g = {k: torch.full(v.shape, 0.3) for k, v in
         {"a": params["tok_embed"], "b": params["final_norm"]}.items()}
    err = init_error_state(g)
    total = {k: torch.zeros_like(v) for k, v in g.items()}
    for _ in range(8):
        dq, err = compress_grads(g, err)
        total = {k: total[k] + dq[k] for k in total}
    # over many steps, EF makes the quantized sum converge to the true sum
    for k in g:
        np.testing.assert_allclose(total[k].numpy(), 8 * g[k].numpy(),
                                   rtol=0.02, atol=0.02)


def test_int8_quantizer_matches_jax():
    """Half-way values round to even, as ``jnp.round`` does."""
    from repro.train.compress import quantize_int8 as j_quantize_int8
    x = np.asarray([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -3.5, 3.3, -90.2],
                   np.float32)
    q, s = quantize_int8(torch.from_numpy(x))
    jq, js = j_quantize_int8(jnp.asarray(x))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(s) == float(js)


def test_compressed_training_converges(small_model):
    cfg, m = small_model
    tc = TrainerConfig(total_steps=30, log_every=5, compress_grads=True)
    res = Trainer(m, OptConfig(lr=3e-3, warmup_steps=5, total_steps=30),
                  tc, CPU).train(_data_factory(cfg)(0))
    assert res.history[-1]["loss"] < res.history[0]["loss"]


def test_grad_accumulation(small_model):
    """Two micro-batches of 4 accumulate to the step on the batch of 8."""
    cfg, m = small_model

    def gen():
        i = 0
        while True:
            b = batches(cfg, "id", 1, 8, 32, seed=9000 + i, device=CPU)[0]
            yield {"tokens": b["tokens"].reshape(2, 4, 32)}  # (accum, micro)
            i += 1

    tc = TrainerConfig(total_steps=10, log_every=2, accum_steps=2)
    res = Trainer(m, OptConfig(lr=1e-3), tc, CPU).train(gen())
    assert np.isfinite(res.history[-1]["loss"])
    # one accumulated step equals one step on the whole batch: the same
    # loss and gradient norm (a scale error would show there: AdamW's first
    # step is invariant to the gradient's scale) and, since that step moves
    # each weight by about lr·sign(g), params within 1e-5 of lr = 1e-3
    oc = OptConfig(lr=1e-3, warmup_steps=1)
    whole = batches(cfg, "id", 1, 8, 32, seed=9000, device=CPU)[0]
    split = {"tokens": whole["tokens"].reshape(2, 4, 32)}
    outs = []
    for accum, b in ((1, whole), (2, split)):
        p = m.init(0, CPU)
        step = make_grad_step(m, oc, TrainerConfig(accum_steps=accum))
        outs.append(step(p, init_opt_state(p), init_error_state(p), b))
    (p1, _, _, m1), (p2, _, _, m2) = outs
    for k in ("loss", "grad_norm"):
        assert float(m2[k]) == pytest.approx(float(m1[k]), rel=1e-5), k
    for a, b in zip(_leaves(p1), _leaves(p2)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# Against the JAX package
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def shared():
    """(JAX model, JAX params, port model, converted params, batch tokens)
    for reduced TinyLlama in f32."""
    jcfg = j_reduced(j_get_config("tinyllama-1.1b"))
    jm = j_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build(convert.convert_config(dataclasses.asdict(jcfg)))
    toks = np.random.default_rng(4).integers(
        0, jcfg.vocab_size, size=(4, 32)).astype(np.int32)
    return jm, jp, tm, toks


def _port_params(jp):
    return convert.convert_params(jax.tree.map(np.asarray, jp))


def _close_to_leaf_scale(got, want, rel, name):
    """|Δ| <= rel · max|want| over each leaf: two frameworks summing in
    another order differ in the last bits of each value, relative to the
    leaf's scale, not to the value (cancelling sums end near 0)."""
    want_by = dict(tree_paths(jax.tree.map(np.asarray, want)))
    for path, t in tree_paths(got):
        w = want_by[path]
        np.testing.assert_allclose(t.numpy(), w, rtol=0,
                                   atol=rel * float(np.abs(w).max()),
                                   err_msg=f"{name} {path}")


def _adamw_step_vs_jax(shared, remat: bool):
    jm, jp, tm, toks = shared
    if remat:
        tm = build(tm.cfg.replace(remat=True))
    oc = dict(lr=1e-3, warmup_steps=2, total_steps=20, grad_clip=0.5)
    jb = {"tokens": jnp.asarray(toks)}
    (jloss, _), jg = jax.value_and_grad(lambda p: jm.loss(p, jb),
                                        has_aux=True)(jp)
    jnew, jst, jom = j_adamw_update(jp, jg, j_init_opt_state(jp),
                                    JOptConfig(**oc))
    tp = _port_params(jp)
    tb = {"tokens": torch.from_numpy(toks)}
    tg, (tloss, _) = value_and_grad(tm.loss, tp, tb)
    assert float(tloss) == pytest.approx(float(jloss), rel=1e-6)
    _close_to_leaf_scale(tg, jg, 1e-5, "grad")
    st = init_opt_state(tp)
    new, st, om = make_train_step(tm, OptConfig(**oc))(tp, st, tb)
    assert float(om["grad_norm"]) > oc["grad_clip"]       # clipping is on
    assert float(om["grad_norm"]) == pytest.approx(float(jom["grad_norm"]),
                                                   rel=1e-5)
    assert float(om["lr"]) == float(jom["lr"]) == pytest.approx(5e-4)
    assert float(om["loss"]) == pytest.approx(float(jloss), rel=1e-6)
    assert int(st["step"]) == int(jst["step"]) == 1
    _close_to_leaf_scale(st["m"], jst["m"], 1e-5, "m")
    _close_to_leaf_scale(st["v"], jst["v"], 1e-5, "v")
    jnew_by = dict(tree_paths(jax.tree.map(np.asarray, jnew)))
    for path, t in tree_paths(new):
        np.testing.assert_allclose(t.numpy(), jnew_by[path], rtol=0,
                                   atol=0.1 * float(om["lr"]), err_msg=path)
        assert np.mean(np.abs(t.numpy() - jnew_by[path]) > 1e-6) < 1e-3


def test_one_adamw_step_matches_jax(shared):
    """Loss, grads, grad norm, lr and the updated params, m and v after one
    clipped step, f32.  Grads, m and v agree to 1e-5 of each leaf's largest
    value (measured: <= 1.6e-6).  The first AdamW step moves a weight by
    lr·g/(|g| + eps): where |g| is within a few eps (1e-8) of 0 that size
    rests on g's last bits, so params agree to 0.1·lr (measured: 0.04·lr,
    in a handful of such weights; 1e-6 elsewhere)."""
    _adamw_step_vs_jax(shared, remat=False)


def test_one_adamw_step_with_remat_matches_jax(shared, monkeypatch):
    """The same step with every layer rematerialised (``remat=True``, as
    the reference's full-width configs train): the same numbers, and the
    layers did go through ``torch.utils.checkpoint``."""
    calls = []
    real = torch.utils.checkpoint.checkpoint

    def counting(fn, *args, **kw):
        calls.append(fn.__name__)
        return real(fn, *args, **kw)

    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint", counting)
    _adamw_step_vs_jax(shared, remat=True)
    # the loss before the step, and make_train_step's step: one call per
    # layer each
    assert calls == ["layer_forward"] * (2 * shared[2].cfg.num_layers)


def test_remat_gradients_equal_no_remat(small_model):
    """Loss and every gradient with ``remat=True`` equal those with
    ``remat=False`` to 1e-6 (reduced TinyLlama, f32; the recompute runs the
    same ops on the same inputs), through the trainer's step on a batch of
    8 x 32 tokens, and remat keeps only the layers' inputs: fewer tensors
    saved for the backward pass."""
    cfg, m = small_model
    params = m.init(0, CPU)
    batch = batches(cfg, "id", 1, 8, 32, seed=11, device=CPU)[0]
    out, saved = {}, {}
    for remat in (False, True):
        mr = build(cfg.replace(remat=remat))
        n = [0]

        def pack(x):
            n[0] += 1
            return x

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda x: x):
            out[remat] = value_and_grad(mr.loss, params, batch)
        saved[remat] = n[0]
    (g0, (l0, _)), (g1, (l1, _)) = out[False], out[True]
    assert float(l1) == pytest.approx(float(l0), abs=1e-6)
    for (path, a), (_, b) in zip(tree_paths(g0), tree_paths(g1)):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0, atol=1e-6,
                                   err_msg=path)
    assert saved[True] < saved[False], saved


def test_snip_on_a_remat_config_runs(small_model):
    """The gradient criteria differentiate with ``torch.func``, which
    refuses ``torch.utils.checkpoint``: on a ``remat=True`` config they run
    without remat and prune the same units."""
    cfg, _ = small_model
    params = build(cfg).init(0, CPU)
    gb = batches(cfg, "id", 1, 4, 16, seed=3, device=CPU)[0]
    res = {r: prune_model(build(cfg.replace(remat=r)), params, 0.5,
                          criterion="snip", grads_batch=gb)
           for r in (False, True)}
    assert res[True].pruned_units == res[False].pruned_units
    assert res[True].cfg == res[False].cfg.replace(remat=True)


def test_port_checkpoint_loads_in_jax_and_back(shared, tmp_path):
    """A checkpoint the port writes (zlib) restores in the JAX package, one
    the JAX package writes (zstd here) restores in the port, and the two
    msgpack payloads are byte for byte the same: the reference's dotted
    keys, order, dtypes and raw bytes, ``opt.step`` an int32 scalar."""
    jm, jp, tm, _ = shared
    jtree = {"params": jp, "opt": j_init_opt_state(jp)}
    jtree["opt"]["step"] = jnp.int32(3)
    ttree = {"params": _port_params(jp), "opt": init_opt_state(
        _port_params(jp))}
    ttree["opt"]["step"] = torch.tensor(3, dtype=torch.int32)
    tpath = ckpt.save_checkpoint(str(tmp_path / "t" / "step_00000003.ckpt"),
                                 3, ttree, meta={"by": "port"})
    jpath = j_ckpt.save_checkpoint(str(tmp_path / "j" / "step_00000003.ckpt"),
                                   3, jtree, meta={"by": "port"})
    step, back, meta = j_ckpt.load_checkpoint(tpath, jtree)
    assert step == 3 and not meta["missing"] and not meta["extra"]
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jtree)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    step, back, meta = ckpt.load_checkpoint(jpath, ttree)
    assert step == 3 and not meta["missing"] and not meta["extra"]
    for a, b in zip(_leaves(back), _leaves(ttree)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert back["opt"]["step"].dtype == torch.int32
    with open(tpath, "rb") as f:
        assert f.read(9)[8:9] == b"D"                 # zlib, always
    assert msgpack.packb(ckpt.load_raw(tpath)) == \
        real_msgpack.packb(j_ckpt.load_raw(jpath), use_bin_type=True)


def test_bfloat16_checkpoint_both_ways(tmp_path):
    """bf16 arrays travel as their raw 16-bit words."""
    x = np.random.default_rng(1).normal(size=(3, 5)).astype(np.float32)
    jtree = {"w": jnp.asarray(x, jnp.bfloat16)}
    ttree = {"w": torch.from_numpy(x).bfloat16()}
    assert np.array_equal(convert.to_numpy(ttree["w"]),
                          np.asarray(jtree["w"]).view(np.uint16))
    tpath = ckpt.save_checkpoint(str(tmp_path / "t.ckpt"), 1, ttree)
    jpath = j_ckpt.save_checkpoint(str(tmp_path / "j.ckpt"), 1, jtree)
    _, jb, _ = j_ckpt.load_checkpoint(tpath, jtree)
    _, tb, _ = ckpt.load_checkpoint(jpath, ttree)
    assert jb["w"].dtype == jnp.bfloat16 and tb["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(np.asarray(jb["w"]).view(np.uint16),
                                  convert.to_numpy(ttree["w"]))
    assert torch.equal(tb["w"], ttree["w"])


def test_zstd_checkpoint_needs_zstandard(tmp_path, monkeypatch):
    """Without the zstandard package a zstd checkpoint is refused by name;
    the port's own (zlib) checkpoints never need it."""
    jpath = j_ckpt.save_checkpoint(str(tmp_path / "j.ckpt"), 1,
                                   {"x": jnp.zeros(3)})
    tpath = ckpt.save_checkpoint(str(tmp_path / "t.ckpt"), 1,
                                 {"x": torch.zeros(3)})
    monkeypatch.setitem(sys.modules, "zstandard", None)
    with pytest.raises(ckpt.CheckpointError, match="zstandard"):
        ckpt.load_raw(jpath)
    assert ckpt.load_raw(tpath)["step"] == 1


def _payload():
    lens = (0, 1, 31, 32, 255, 256, 65535, 65536)
    return {
        "step": 7,
        "meta": {"none": None, "t": True, "f": False, "x": 1.5, "y": -0.0,
                 "ints": [0, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1,
                          2 ** 32, 2 ** 64 - 1, -1, -32, -33, -128, -129,
                          -32768, -32769, -2 ** 31, -2 ** 31 - 1, -2 ** 63],
                 "strs": ["x" * n for n in lens], "ü": "ßü€",
                 "arr15": list(range(15)), "arr16": list(range(16)),
                 "map16": {str(i): i for i in range(16)}},
        "arrays": {f"b{n}": {"dtype": "uint8", "shape": [n],
                             "data": bytes(range(256)) * (n // 256)
                             + bytes(n % 256)} for n in lens},
    }


def test_msgpack_bytes_equal_the_msgpack_package():
    obj = _payload()
    raw = msgpack.packb(obj)
    assert raw == real_msgpack.packb(obj, use_bin_type=True)
    assert msgpack.unpackb(raw) == real_msgpack.unpackb(raw, raw=False) \
        == obj
    single = real_msgpack.packb({"f": 0.25}, use_single_float=True)
    assert msgpack.unpackb(single) == {"f": 0.25}
    with pytest.raises(msgpack.MsgpackError):
        msgpack.unpackb(raw[:-1])


def test_rf_rp_against_jax(shared):
    """RP exactly; RF within 1 % of the reference's with its layers unrolled
    (``use_scan=False``).  The port counts the matrix products
    (FlopCounterMode); XLA's cost analysis also counts the elementwise work
    (2.9 % of the FLOPs at this reduced width, d 64, S 32), which moves the
    ratio by 0.5 %.  With the layers under ``lax.scan`` (the reference's
    default) the cost analysis counts the loop body once, not once per
    layer, so that RF (1.585 here) is not the model's."""
    jm, jp, tm, toks = shared
    unrolled = jm.cfg.replace(use_scan=False)
    jr = j_prune_model(jm, jp, 0.5, criterion="l1")
    tp = _port_params(jp)
    tr = prune_model(tm, tp, 0.5, criterion="l1")
    jb = {"tokens": jnp.asarray(toks)}
    want = j_rf_rp(j_build(unrolled), jp,
                   j_build(jr.cfg.replace(use_scan=False)), jr.params, jb)
    got = rf_rp(tm, tp, build(tr.cfg), tr.params,
                {"tokens": torch.from_numpy(toks)})
    assert got["params_before"] == want["params_before"] == param_count(tp)
    assert got["params_after"] == want["params_after"]
    assert got["RP"] == want["RP"]
    assert abs(got["RF"] / want["RF"] - 1) < 0.01, (got, want)
    for k in ("flops_before", "flops_after"):    # elementwise uncounted
        assert 0.95 * want[k] < got[k] < want[k], (k, got, want)


def test_model_loss_kernel_branch_vs_jax_pallas(shared, monkeypatch):
    """The port of ``test_model_pallas_parity``: the reference's loss with
    ``use_pallas=True`` (Pallas flash attention, interpret mode) against the
    port's loss on the plain attention and on the flash-attention branch
    (routed here on CPU tensors, where ``ops.flash_attention`` runs its
    plain version): |Δ| < 1e-3."""
    jm, jp, tm, toks = shared
    jl = float(j_build(jm.cfg.replace(use_pallas=True)).loss(
        jp, {"tokens": jnp.asarray(toks)})[0])
    tp = _port_params(jp)
    tb = {"tokens": torch.from_numpy(toks)}
    with torch.no_grad():
        plain = float(tm.loss(tp, tb)[0])
        calls = []
        from repro_torch.kernels.flash_attention import ops as fa_ops
        real = fa_ops.flash_attention_ref

        def counted(*a, **k):
            calls.append(1)
            return real(*a, **k)
        monkeypatch.setattr(fa_ops, "flash_attention_ref", counted)
        monkeypatch.setattr(t_attention, "_on_kernel",
                            lambda cfg, x: cfg.use_kernels)
        branch = float(tm.loss(tp, tb)[0])
    assert len(calls) == tm.cfg.num_layers
    assert abs(plain - jl) < 1e-3 and abs(branch - jl) < 1e-3
    assert abs(branch - plain) < 1e-5


def test_cli_trains_and_prunes_mid_run_on_the_cpu(monkeypatch, capsys):
    from repro_torch.launch import train as cli
    for extra in ([], ["--prune-ratio", "0.5", "--prune-at", "10"]):
        monkeypatch.setattr(sys, "argv", [
            "train", "--arch", "tinyllama-1.1b", "--reduced", "--steps", "20",
            "--device", "cpu", *extra])
        cli.main()
        out = capsys.readouterr().out
        first, last = (float(x) for x in
                       out.split("loss: ")[1].split()[0:3:2])
        assert last < first, out
        if extra:
            assert "pruned: d_ff 128->64, heads 4->2" in out


def test_cli_without_a_device_raises_here(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is the card")
    from repro_torch.launch import train as cli
    monkeypatch.setattr(sys, "argv", ["train", "--arch", "tinyllama-1.1b",
                                      "--reduced", "--steps", "2"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main()
