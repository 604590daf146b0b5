"""The port's serving engine on the SSM family (Mamba-2): against its own
sequential oracle (``launch.serve.generate``) token for token, and against
the JAX engine.

f32 on the CPU (``device="cpu"`` asked for explicitly), reduced
``mamba2-1.3b``.  Exact token equality is demanded only inside the port
(engine vs oracle on the same weights and arithmetic), dense and 50 %
pruned by the port's own pruner, with chunked and token-by-token prefill
and through preemption.  Against the JAX engine the scheduling is compared
exactly and the tokens under teacher forcing (random-init logits are
near-tied).  The engine's recurrent-family gates: every paged decode step
carries the ``active`` mask (the dense one is sent none), a reused slot
starts from zero state, prefix caching is refused and blocks cannot be
handed off.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as j_get_config, reduced as j_reduced
from repro.models import build as j_build
from repro.serve import Engine as JEngine, ServeConfig as JServeConfig
from repro_torch import convert
from repro_torch.core.pruner import prune_model
from repro_torch.launch.serve import generate
from repro_torch.models import build as t_build
from repro_torch.serve import Engine, ServeConfig
from test_torch_engine import _plan_trace, count_sampling_steps

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

_MODELS: dict = {}


def models(pruned: bool = False):
    """(JAX model, JAX params, port model, port params) on shared weights;
    ``pruned`` = the port model 50 % L1-pruned by the port's pruner (no JAX
    counterpart is returned then)."""
    if pruned not in _MODELS:
        if pruned:
            _, _, tm, tp = models()
            pr = prune_model(tm, tp, 0.5, criterion="l1")
            _MODELS[pruned] = (None, None, t_build(pr.cfg), pr.params)
        else:
            jm = j_build(j_reduced(j_get_config("mamba2-1.3b")))
            jp = jm.init(jax.random.PRNGKey(0))
            tm = t_build(convert.convert_config(dataclasses.asdict(jm.cfg)))
            tp = convert.convert_params(jax.tree.map(np.asarray, jp))
            _MODELS[pruned] = (jm, jp, tm, tp)
    return _MODELS[pruned]


def prompts(V, B, P, seed):
    return np.random.default_rng(seed).integers(0, V, size=(B, P))


def oracle(tm, tp, prompt, gen):
    with torch.no_grad():
        return generate(tm, tp, torch.from_numpy(prompt), gen).numpy()


def serve(tm, tp, prompt_rows, gen, **cfg):
    eng = Engine(tm, tp, ServeConfig(**cfg), device="cpu")
    sampling = count_sampling_steps(eng)
    rids = [eng.add_request([int(t) for t in row], max_new_tokens=gen)
            for row in prompt_rows]
    out, stats = eng.run()
    stats["sampling_steps"] = sampling[0]
    return eng, rids, out, stats


ORACLE_CASES = {
    # odd prompt length -> a partial last chunk; chunk = the SSM chunk
    "dense": dict(pruned=False, B=3, P=21, gen=6,
                  cfg=dict(max_seqs=2, block_size=4, max_len=40,
                           chunk_size=16)),
    "pruned": dict(pruned=True, B=3, P=21, gen=6,
                   cfg=dict(max_seqs=2, block_size=4, max_len=40,
                            chunk_size=16)),
    # chunks that are not SSM-chunk multiples, under a prefill budget
    "small-chunks-budget": dict(pruned=False, B=3, P=13, gen=5,
                                cfg=dict(max_seqs=3, block_size=4,
                                         max_len=32, chunk_size=4,
                                         prefill_budget=6)),
    "token-by-token": dict(pruned=False, B=2, P=7, gen=4,
                           cfg=dict(max_seqs=2, block_size=4, max_len=16,
                                    chunk_size=0)),
    # a pool too small for every request: eviction and re-prefill
    "preemption": dict(pruned=False, B=4, P=10, gen=12, preempt=True,
                       cfg=dict(max_seqs=4, block_size=4, max_len=24,
                                num_blocks=13, chunk_size=4)),
    "preemption-pruned": dict(pruned=True, B=4, P=10, gen=12, preempt=True,
                              cfg=dict(max_seqs=4, block_size=4, max_len=24,
                                       num_blocks=13, chunk_size=4)),
}


@pytest.mark.parametrize("case", sorted(ORACLE_CASES))
def test_engine_matches_oracle(case):
    spec = ORACLE_CASES[case]
    _, _, tm, tp = models(spec["pruned"])
    prompt = prompts(tm.cfg.vocab_size, spec["B"], spec["P"], seed=13)
    ref = oracle(tm, tp, prompt, spec["gen"])
    eng, rids, out, stats = serve(tm, tp, prompt, spec["gen"], **spec["cfg"])
    for b, rid in enumerate(rids):
        assert out[rid].tokens == list(ref[b, spec["P"]:]), (case, b)
    if spec.get("preempt"):
        assert sum(out[r].preemptions for r in rids) > 0
    if spec["cfg"]["chunk_size"] > 1:
        assert stats["prefill_chunks"] > 0 and stats["prefill_calls"] > 0
    assert 0 < stats["host_syncs"] == stats["sampling_steps"] \
        <= stats["steps"]
    assert eng.cache_host.allocator.num_live == 0
    eng.cache_host.check()


@pytest.mark.parametrize("chunk_size", [0, 4])
def test_slot_reuse_starts_from_zero_state(chunk_size):
    """Port of ``test_engine_ssm_state_reset_on_slot_reuse``: a long request
    pollutes slot 0's recurrent state, then a short one in the SAME slot
    must match a fresh sequential decode."""
    _, _, tm, tp = models()
    long_p = prompts(tm.cfg.vocab_size, 1, 12, seed=21)[0].tolist()
    short_p = [5, 3]
    ref = oracle(tm, tp, np.asarray([short_p]), 6)
    eng = Engine(tm, tp, ServeConfig(max_seqs=1, block_size=4, max_len=32,
                                     chunk_size=chunk_size), device="cpu")
    eng.add_request(long_p, max_new_tokens=4)
    r2 = eng.add_request(short_p, max_new_tokens=6)
    out, _ = eng.run()
    assert out[r2].tokens == list(ref[0, len(short_p):])


def test_prefix_caching_and_block_handoff_refused():
    """Requests behind a shared prefix alias nothing (the recurrent state is
    per slot, not rebuilt from KV blocks) and still match the oracle; the
    dense family keeps both capabilities."""
    _, _, tm, tp = models()
    V = tm.cfg.vocab_size
    rng = np.random.default_rng(19)
    prefix = rng.integers(0, V, size=8)
    rows = [np.concatenate([prefix, rng.integers(0, V, size=6)]),
            np.concatenate([prefix, rng.integers(0, V, size=2)]),
            prefix.copy()]
    gen = 5
    eng, rids, out, stats = serve(tm, tp, rows, gen, max_seqs=2,
                                  block_size=4, max_len=24, chunk_size=4,
                                  prefix_caching=True)
    for r, rid in zip(rows, rids):
        assert out[rid].tokens == list(oracle(tm, tp, r[None], gen)[0,
                                                                   len(r):])
    assert eng.cache_host.prefix_hits == 0 and stats["cow_copies"] == 0
    assert not eng._prefix_ok and not eng.can_handoff_blocks
    assert set(eng.cache) == {"conv", "state"}          # no KV pools
    from test_torch_engine import models as dense_models
    _, _, dm, dp = dense_models()
    dense = Engine(dm, dp, ServeConfig(), device="cpu")
    assert dense._prefix_ok and dense.can_handoff_blocks


def test_decode_step_receives_the_active_mask(monkeypatch):
    """Every paged decode call of the recurrent family carries ``active``:
    slots mid-prefill ride the decode batch inactive and keep their state."""
    _, _, tm, tp = models()
    seen = []
    real = type(tm).paged_decode_step

    def spy(self, params, cache, tokens, positions, tables, active=None):
        seen.append(None if active is None else active.clone())
        return real(self, params, cache, tokens, positions, tables, active)
    monkeypatch.setattr(type(tm), "paged_decode_step", spy)
    prompt = prompts(tm.cfg.vocab_size, 3, 11, seed=5)
    ref = oracle(tm, tp, prompt, 4)
    _, rids, out, _ = serve(tm, tp, prompt, 4, max_seqs=3, block_size=4,
                            max_len=24, chunk_size=4, prefill_budget=4)
    assert seen and all(a is not None and a.dtype == torch.bool
                        for a in seen)
    assert any(not bool(a.all()) for a in seen)     # some slot rode inactive
    for b, rid in enumerate(rids):
        assert out[rid].tokens == list(ref[b, 11:])


def test_dense_decode_step_is_sent_no_mask(monkeypatch):
    """The dense step never reads ``active``: the engine uploads no mask for
    it, so a dense decode call costs no extra copy or cast."""
    from test_torch_engine import models as dense_models
    _, _, dm, dp = dense_models()
    seen = []
    real = type(dm).paged_decode_step

    def spy(self, params, cache, tokens, positions, tables, active=None):
        seen.append(active)
        return real(self, params, cache, tokens, positions, tables, active)
    monkeypatch.setattr(type(dm), "paged_decode_step", spy)
    serve(dm, dp, prompts(dm.cfg.vocab_size, 2, 5, seed=7), 3, max_seqs=2,
          block_size=4, max_len=16, chunk_size=4)
    assert seen and all(a is None for a in seen)


@pytest.mark.parametrize("scenario", ["chunked-prefix", "preemption"])
def test_port_engine_vs_jax_engine(scenario):
    """Same weights, same requests, temperature 0: identical per-step plans
    and block accounting; tokens under teacher forcing."""
    jm, jp, tm, tp = models()
    V = tm.cfg.vocab_size
    rng = np.random.default_rng(29)
    if scenario == "chunked-prefix":
        prefix = rng.integers(0, V, size=8)
        rows = [np.concatenate([prefix, rng.integers(0, V, size=n)])
                for n in (6, 2, 0)] + [rng.integers(0, V, size=9)]
        cfg = dict(max_seqs=2, block_size=4, max_len=24, chunk_size=4)
        gen = 5
    else:
        rows = list(prompts(V, 4, 10, seed=31))
        cfg = dict(max_seqs=4, block_size=4, max_len=24, num_blocks=13,
                   chunk_size=4, prefill_budget=6)
        gen = 10

    jeng = JEngine(jm, jp, JServeConfig(**cfg))
    jtrace = _plan_trace(jeng)
    for r in rows:
        jeng.add_request([int(t) for t in r], max_new_tokens=gen)
    jout, jstats = jeng.run()

    teng = Engine(tm, tp, ServeConfig(**cfg), device="cpu")
    ttrace = _plan_trace(teng)
    for r in rows:
        teng.add_request([int(t) for t in r], max_new_tokens=gen)
    emitted: dict[int, list[int]] = {i: [] for i in range(len(rows))}
    while teng.scheduler.has_work:
        running = teng.step()
        for s in running:                       # teacher forcing: go on
            rid, n = s.req.rid, len(s.generated)    # from JAX's tokens
            emitted[rid].extend(s.generated[len(emitted[rid]):n])
            s.generated[:] = jout[rid].tokens[:n]
    tstats = {k: c.value for k, c in teng._c.items()}   # registry counters

    assert len(ttrace) == len(jtrace)
    for i, (a, b) in enumerate(zip(ttrace, jtrace)):
        assert a == b, f"plan {i} differs"
    for k in ("steps", "prefill_chunks", "prefill_tokens", "decode_tokens",
              "cow_copies"):
        assert tstats[k] == jstats[k], k
    if scenario == "preemption":
        assert any(p["preempted"] for p in ttrace)
    else:
        assert not any(p["copies"] for p in ttrace)     # nothing aliased

    for rid, r in enumerate(rows):
        seq = np.concatenate([r, np.asarray(jout[rid].tokens)])
        logits = np.asarray(jm.forward(
            jp, {"tokens": jnp.asarray(seq[None].astype(np.int32))}))[0]
        at = logits[len(r) - 1:len(r) - 1 + gen]
        assert len(emitted[rid]) == gen
        short = at.max(axis=1) - at[np.arange(gen), emitted[rid]]
        assert short.max() <= 1e-4, (rid, short.max())


@pytest.mark.parametrize("prune", [False, True], ids=["dense", "pruned"])
def test_cli_serves_mamba2_on_the_cpu(prune, capsys):
    from repro_torch.launch import serve as cli
    args = ["--arch", "mamba2-1.3b", "--reduced", "--requests", "5",
            "--prompt-len", "20", "--gen", "4", "--max-seqs", "2",
            "--block-size", "4", "--chunk-size", "16", "--device", "cpu"]
    cli.main(args + (["--prune-ratio", "0.5"] if prune else []))
    out = capsys.readouterr().out
    assert "served 5 requests / 20 new tokens" in out
    if prune:
        assert "ssm heads 4, ssm head_dim 8, state 8" in out


def test_cli_obspa_on_mamba2_names_its_roadmap_item(capsys):
    """OBSPA for SSM consumers is ported (it once raised naming its ROADMAP
    item): the CLI OBSPA-prunes reduced Mamba-2 on the CPU and serves it."""
    from repro_torch.launch import serve as cli
    cli.main(["--arch", "mamba2-1.3b", "--reduced", "--prune-ratio", "0.5",
              "--obspa", "--requests", "3", "--prompt-len", "16", "--gen",
              "4", "--max-seqs", "2", "--block-size", "4", "--chunk-size",
              "16", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "ssm heads 4, ssm head_dim 8, state 8" in out
    assert "served 3 requests / 12 new tokens" in out
