"""The port's serving engine on the hybrid family (Hymba): against the JAX
engine and against its own sequential oracle (``launch.serve.generate``),
and the CLI.

f32 on the CPU (``device="cpu"`` asked for explicitly), reduced
``hymba-1.5b`` on weights converted from the JAX package
(``test_torch_hybrid.models``), prompts of 40-60 tokens: past the window of
32 and no multiple of the SSM chunk.  Against the JAX engine the per-step
plans and block accounting are compared exactly and the tokens under
teacher forcing (shortfall <= 1e-4: random-init logits are near-tied);
against the port's oracle the tokens exactly, dense and 50 % L1-pruned by
the port's pruner, with chunked prefill under a budget and through
preemption.  The recurrent-family gates: prefix matching refused, no block
hand-off.  The CLI serves reduced Hymba dense, L1- and OBSPA-pruned on the
CPU, printing the attention and the SSM dims of a pruned model.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.serve import Engine as JEngine, ServeConfig as JServeConfig
from repro_torch.core.pruner import prune_model
from repro_torch.launch.serve import generate
from repro_torch.models import build as t_build
from repro_torch.serve import Engine, ServeConfig
from test_torch_engine import _plan_trace, count_sampling_steps
from test_torch_hybrid import _MODELS, models, one_thread  # noqa: F401

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def port_pruned():
    """The port model 50 % L1-pruned by the port's pruner."""
    if "pruned" not in _MODELS:
        _, _, tm, tp = models()
        pr = prune_model(tm, tp, 0.5, criterion="l1")
        _MODELS["pruned"] = (t_build(pr.cfg), pr.params)
    return _MODELS["pruned"]


def prompt_rows(V, n, seed):
    """``n`` prompts of 40-60 tokens: past the window, no chunk multiple."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, V, size=int(L))
            for L in rng.integers(40, 61, size=n)]


def oracle(tm, tp, row, gen):
    with torch.no_grad():
        return generate(tm, tp, torch.from_numpy(row)[None], gen)[0, len(
            row):].tolist()


SERVE_CASES = {
    "chunked-prefill": dict(gen=6, cfg=dict(
        max_seqs=2, block_size=8, max_len=72, chunk_size=16,
        prefill_budget=24)),
    # a pool too small for every request: eviction and re-prefill
    "preemption": dict(gen=8, cfg=dict(
        max_seqs=4, block_size=8, max_len=72, num_blocks=29,
        chunk_size=16)),
}


@pytest.mark.parametrize("scenario", sorted(SERVE_CASES))
def test_port_engine_vs_jax_engine(scenario):
    """Same weights, same requests, temperature 0: identical per-step plans
    and block accounting; tokens under teacher forcing."""
    jm, jp, tm, tp = models()
    spec = SERVE_CASES[scenario]
    rows = prompt_rows(tm.cfg.vocab_size, 4, seed=29)
    gen, cfg = spec["gen"], spec["cfg"]

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

    for rid, r in enumerate(rows):
        seq = np.concatenate([r, np.asarray(jout[rid].tokens)])
        logits = np.asarray(jm.forward(
            jp, {"tokens": jnp.asarray(seq[None].astype(np.int32))}))[0]
        at = logits[len(r) - 1:len(r) - 1 + gen]
        assert len(emitted[rid]) == gen
        short = at.max(axis=1) - at[np.arange(gen), emitted[rid]]
        assert short.max() <= 1e-4, (rid, short.max())


@pytest.mark.parametrize("pruned", [False, True], ids=["dense", "pruned"])
@pytest.mark.parametrize("scenario", sorted(SERVE_CASES))
def test_engine_matches_oracle(scenario, pruned):
    tm, tp = port_pruned() if pruned else models()[2:]
    spec = SERVE_CASES[scenario]
    rows = prompt_rows(tm.cfg.vocab_size, 4, seed=31)
    eng = Engine(tm, tp, ServeConfig(**spec["cfg"]), device="cpu")
    sampling = count_sampling_steps(eng)
    rids = [eng.add_request([int(t) for t in r],
                            max_new_tokens=spec["gen"]) for r in rows]
    out, stats = eng.run()
    for r, rid in zip(rows, rids):
        assert out[rid].tokens == oracle(tm, tp, r, spec["gen"]), rid
    if scenario == "preemption":
        assert sum(out[r].preemptions for r in rids) > 0
    assert stats["prefill_chunks"] > 0
    assert 0 < stats["host_syncs"] == sampling[0] <= stats["steps"]
    assert eng.cache_host.allocator.num_live == 0
    eng.cache_host.check()


def test_recurrent_family_disables_prefix_matching():
    """Aliased KV blocks cannot rebuild the per-slot SSM state: the engine
    prefix-matches nothing, identical prompts still decode identically (by
    full chunked prefill) and match the oracle; blocks cannot be handed
    off."""
    _, _, tm, tp = models()
    prompt = prompt_rows(tm.cfg.vocab_size, 1, seed=37)[0]
    eng = Engine(tm, tp, ServeConfig(max_seqs=1, block_size=4, max_len=64,
                                     chunk_size=16, prefix_caching=True),
                 device="cpu")
    assert not eng.cache_host.prefix_caching and not eng.can_handoff_blocks
    assert set(eng.cache) == {"k", "v", "conv", "state"}
    r1 = eng.add_request([int(t) for t in prompt], max_new_tokens=5)
    r2 = eng.add_request([int(t) for t in prompt], max_new_tokens=5)
    out, stats = eng.run()
    assert out[r1].tokens == oracle(tm, tp, prompt, 5) == out[r2].tokens
    assert eng.cache_host.prefix_hits == 0 and stats["cow_copies"] == 0



@pytest.mark.parametrize("mode", ["dense", "l1", "obspa"])
def test_cli_serves_hymba_on_the_cpu(mode, capsys):
    from repro_torch.launch import serve as cli
    args = ["--arch", "hymba-1.5b", "--reduced", "--requests", "4",
            "--prompt-len", "40", "--gen", "4", "--max-seqs", "2",
            "--block-size", "8", "--chunk-size", "16", "--device", "cpu"]
    if mode != "dense":
        args += ["--prune-ratio", "0.5"]
    if mode == "obspa":
        args += ["--obspa"]
    cli.main(args)
    out = capsys.readouterr().out
    assert "served 4 requests / 16 new tokens" in out
    if mode != "dense":
        assert ("heads 2, kv heads 1, v_head_dim 8, d_ff 64; ssm heads 4, "
                "ssm head_dim 8, state 8") in out


def test_cli_without_a_device_raises_here():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch.launch import serve as cli
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--arch", "hymba-1.5b", "--reduced", "--prune-ratio",
                  "0.5"])
