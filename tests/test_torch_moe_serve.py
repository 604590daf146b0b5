"""The port's serving engine on the moe family: against its own sequential
oracle (``launch.serve.generate``), the paged steps against the JAX
package's under teacher forcing, and the CLI.

f32 on the CPU (``device="cpu"`` asked for explicitly), reduced
``qwen2-moe-a2.7b`` (8 experts top-2, 2 shared experts) on weights converted
from the JAX package (``test_torch_moe.models``), at the published capacity
factor (1.25), as the JAX package's own engine tests run it.

Each engine-vs-oracle case mirrors a reference test
(``tests/test_serve_parity.py::test_chunked_prefill_matches_oracle``: odd
prompts, so a partial last chunk; ``test_prefill_budget_throttles_but_
preserves_outputs``; ``tests/test_serve.py::test_engine_moe_family``) and
adds idle slots.  The oracle decodes one row a step, so no assignment of
its ever passes the capacity; the engine's steps carry several rows, so
each case counts the real tokens' dropped assignments over its run and
asserts them 0, a stated precondition of equal tokens (a drop is the
reference's semantics, not a fault).  The tokens must then be equal, dense
and 50 % L1-pruned by the port's pruner.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro_torch.core.pruner import prune_model
from repro_torch.launch.serve import generate
from repro_torch.models import build as t_build
from repro_torch.models import moe as t_moe
from repro_torch.models import transformer as tf
from repro_torch.serve import Engine, ServeConfig
from test_torch_engine import count_sampling_steps
from test_torch_moe import (MARGIN, _MODELS, _captured_moe_inputs, close,
                            models, one_thread, routing, T)  # noqa: F401

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def port_pruned():
    """The port model 50 % L1-pruned by the port's pruner."""
    if "pruned" not in _MODELS:
        _, _, tm, tp = models()
        pr = prune_model(tm, tp, 0.5, criterion="l1")
        _MODELS["pruned"] = (t_build(pr.cfg), pr.params)
    return _MODELS["pruned"]


def oracle(tm, tp, row, gen):
    with torch.no_grad():
        return generate(tm, tp, torch.from_numpy(row)[None], gen)[0, len(
            row):].tolist()


SERVE_CASES = {
    # test_chunked_prefill_matches_oracle: B 2, P 11, chunk 4
    "chunked-prefill": dict(lens=(11, 11), gen=6, cfg=dict(
        max_seqs=2, block_size=4, max_len=32, chunk_size=4)),
    # test_prefill_budget_throttles_but_preserves_outputs
    "prefill-budget": dict(lens=(13, 13, 13), gen=5, cfg=dict(
        max_seqs=3, block_size=4, max_len=32, chunk_size=4,
        prefill_budget=4)),
    # test_engine_moe_family, with more slots than requests: idle rows
    "idle-slots": dict(lens=(6, 9, 3), gen=5, cfg=dict(
        max_seqs=5, block_size=4, max_len=16, chunk_size=4)),
}


@pytest.mark.parametrize("pruned", [False, True], ids=["dense", "pruned"])
@pytest.mark.parametrize("scenario", sorted(SERVE_CASES))
def test_engine_matches_oracle(scenario, pruned):
    tm, tp = port_pruned() if pruned else models()[2:]
    spec = SERVE_CASES[scenario]
    rng = np.random.default_rng(31)
    rows = [rng.integers(0, tm.cfg.vocab_size, size=n) for n in spec["lens"]]
    eng = Engine(tm, tp, ServeConfig(**spec["cfg"]), device="cpu")
    sampling = count_sampling_steps(eng)
    rids = [eng.add_request([int(t) for t in r],
                            max_new_tokens=spec["gen"]) for r in rows]
    t_moe.reset_dropped()
    out, stats = eng.run()
    assert t_moe.dropped_assignments() == 0, "precondition: no drops"
    for r, rid in zip(rows, rids):
        assert out[rid].tokens == oracle(tm, tp, r, spec["gen"]), rid
    assert stats["prefill_chunks"] > 0
    assert 0 < stats["host_syncs"] == sampling[0] <= stats["steps"]
    assert eng.cache_host.allocator.num_live == 0
    eng.cache_host.check()


def test_dropped_assignments_counted_in_a_serve():
    """At a capacity factor of 0.25 the engine's prefill steps drop real
    tokens' assignments, and the counter sees them; padding rows are never
    counted (a step of one real token drops nothing)."""
    _, _, tm, tp = models()
    m = t_build(tm.cfg.replace(capacity_factor=0.25))
    rows = [np.random.default_rng(3).integers(0, tm.cfg.vocab_size, 12)
            for _ in range(3)]
    eng = Engine(m, tp, ServeConfig(max_seqs=3, block_size=4, max_len=32,
                                    chunk_size=12), device="cpu")
    for r in rows:
        eng.add_request([int(t) for t in r], max_new_tokens=2)
    t_moe.reset_dropped()
    eng.run()
    # 36 tokens x 2 assignments into 8 experts of 8 slots in the prefill
    assert t_moe.dropped_assignments() > 0
    t_moe.reset_dropped()
    with torch.no_grad():
        tm_cache = m.init_paged_cache(9, 4, 3, device="cpu")
        m.paged_decode_step(tp, tm_cache, T(np.array([1, 2, 3], np.int32)),
                            T(np.array([0, 0, 0], np.int32)),
                            T(np.zeros((3, 2), np.int32)),
                            T(np.array([True, False, False])))
    assert t_moe.dropped_assignments() == 0


def test_paged_steps_vs_jax(monkeypatch):
    """The paged rollout under teacher forcing: both packages' paged steps
    fed the same tokens — three prefill chunks (ragged valid, an idle row)
    then decode steps with an inactive slot.  Every real token's routing is
    clear of ties (precondition); the logits of the real rows and the KV
    pools (outside the null block) agree after every step."""
    jm, jp, tm, tp = models()
    rng = np.random.default_rng(13)
    V = jm.cfg.vocab_size
    B, C, bs, NB = 3, 8, 4, 8
    P = B * NB + 1
    tables = np.arange(1, P).reshape(B, NB).astype(np.int32)
    jc = jm.init_paged_cache(P, bs, B)
    tc = tm.init_paged_cache(P, bs, B, device="cpu")
    slots = np.arange(B, dtype=np.int32)
    j_prefill = jax.jit(jm.paged_prefill_step)
    j_decode = jax.jit(jm.paged_decode_step)
    seen = _captured_moe_inputs(monkeypatch, t_moe)

    def routed_clear(real, what):
        L = tm.cfg.num_layers
        for i, x in enumerate(seen[-L:]):
            router = tf._layer(tp["layers"]["moe"], i)["router"]
            _, gap = routing(router, x, tm.cfg.top_k, real)
            assert gap > MARGIN, (what, i, gap)

    def pools(what):
        for n in ("k", "v"):
            close(tc[n][:, 1:], np.asarray(jc[n])[:, 1:], what=f"{what} {n}")

    with torch.no_grad():
        for i, (starts, valid) in enumerate((
                ([0, 0, 0], [8, 0, 5]), ([8, 0, 5], [8, 6, 8]),
                ([16, 6, 13], [3, 8, 0]))):
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
            routed_clear(np.arange(C)[None, :] < val[:, None], f"prefill {i}")
            rows = val > 0
            close(tl[torch.from_numpy(rows)], np.asarray(jl)[rows],
                  what=f"prefill {i}")
            pools(f"prefill {i}")
        positions = np.asarray([19, 14, 13], np.int32)
        for i in range(5):
            active = np.asarray([True, i % 2 == 0, i >= 2])
            tab = np.where(active[:, None], tables, 0).astype(np.int32)
            tok = rng.integers(0, V, size=(B,)).astype(np.int32)
            jl, jc = j_decode(
                jp, jc, jnp.asarray(tok), jnp.asarray(positions),
                jnp.asarray(tab), jnp.asarray(active))
            tl, tc = tm.paged_decode_step(tp, tc, T(tok), T(positions),
                                          T(tab), T(active, torch.bool))
            routed_clear(active[:, None], f"decode {i}")
            close(tl[torch.from_numpy(active)], np.asarray(jl)[active],
                  what=f"decode {i}")
            pools(f"decode {i}")
            positions = positions + active.astype(np.int32)


@pytest.mark.parametrize("mode", ["dense", "l1", "obspa"])
def test_cli_serves_qwen2_moe_on_the_cpu(mode, capsys):
    from repro_torch.launch import serve as cli
    args = ["--arch", "qwen2-moe-a2.7b", "--reduced", "--requests", "4",
            "--prompt-len", "24", "--gen", "4", "--max-seqs", "2",
            "--block-size", "8", "--chunk-size", "16", "--device", "cpu"]
    if mode != "dense":
        args += ["--prune-ratio", "0.5"]
    if mode == "obspa":
        args += ["--obspa"]
    cli.main(args)
    out = capsys.readouterr().out
    assert "served 4 requests / 16 new tokens" in out
    if mode != "dense":
        assert ("heads 2, kv heads 2, v_head_dim 8, d_ff 0; experts 4 "
                "top-2, moe_d_ff 16, shared width 64") in out
