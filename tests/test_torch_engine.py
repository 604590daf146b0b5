"""The port's serving engine: against its own sequential oracle
(``launch.serve.generate``) token for token, and against the JAX engine.

f32 on the CPU (``device="cpu"`` asked for explicitly), reduced configs.
Exact token equality is demanded only inside the port (engine vs oracle on
the same weights and arithmetic).  Across frameworks the scheduling is
compared exactly and the tokens under teacher forcing: random-init logits
are near-tied, so each token the port emits must have a reference logit
within 1e-4 of the reference maximum at its position.
"""
import dataclasses
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as j_get_config, reduced as j_reduced
from repro.core.pruner import prune_model
from repro.models import build as j_build
from repro.serve import Engine as JEngine, ServeConfig as JServeConfig
from repro_torch import convert
from repro_torch.launch.serve import generate, synthetic_prompts
from repro_torch.models import build as t_build
from repro_torch.serve import Engine, ServeConfig

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
_MODELS: dict = {}


def models(pruned: bool = False):
    """(JAX model, JAX params, port model, port params), shared weights;
    ``pruned`` = 50 % L1-pruned by the JAX pruner, then converted."""
    if pruned not in _MODELS:
        jm = j_build(j_reduced(j_get_config("tinyllama-1.1b")))
        jp = jm.init(jax.random.PRNGKey(0))
        if pruned:
            pr = prune_model(jm, jp, 0.5, criterion="l1")
            jm, jp = j_build(pr.cfg), pr.params
        tm = t_build(convert.convert_config(dataclasses.asdict(jm.cfg)))
        tp = convert.convert_params(jax.tree.map(np.asarray, jp))
        _MODELS[pruned] = (jm, jp, tm, tp)
    return _MODELS[pruned]


def prompts(V, B, P, seed):
    return np.random.default_rng(seed).integers(0, V, size=(B, P))


def oracle(tm, tp, prompt, gen):
    return generate(tm, tp, torch.from_numpy(prompt), gen).numpy()


def count_sampling_steps(eng):
    """Count the planned steps that sample a token — those with a decode row
    or with a prefill chunk that reaches the end of its prompt: each owes the
    host one fetch.  Returns a one-element list holding the count."""
    count = [0]
    plan_step = eng.scheduler.plan_step

    def counted(*args, **kw):
        plan = plan_step(*args, **kw)
        if plan.decode or any(s.num_cached + n == s.seq_len
                              for s, n in plan.prefill):
            count[0] += 1
        return plan

    eng.scheduler.plan_step = counted
    return count


def serve(tm, tp, prompt_rows, gen, **cfg):
    eng = Engine(tm, tp, ServeConfig(**cfg), device="cpu")
    sampling = count_sampling_steps(eng)
    rids = [eng.add_request([int(t) for t in row], max_new_tokens=gen)
            for row in prompt_rows]
    out, stats = eng.run()
    stats["sampling_steps"] = sampling[0]
    return eng, rids, out, stats


ORACLE_CASES = {
    # odd prompt length -> a partial last chunk
    "dense": dict(pruned=False, B=2, P=11, gen=6,
                  cfg=dict(max_seqs=2, block_size=4, max_len=32,
                           chunk_size=4)),
    "jax-pruned": dict(pruned=True, B=2, P=11, gen=6,
                       cfg=dict(max_seqs=2, block_size=4, max_len=32,
                                chunk_size=4)),
    "prefill-budget": dict(pruned=False, B=3, P=13, gen=5,
                           cfg=dict(max_seqs=3, block_size=4, max_len=32,
                                    chunk_size=4, prefill_budget=4)),
    "token-by-token": dict(pruned=False, B=2, P=7, gen=4,
                           cfg=dict(max_seqs=2, block_size=4, max_len=16,
                                    chunk_size=0)),
    "more-requests-than-slots": dict(
        pruned=False, B=5, P=9, gen=4,
        cfg=dict(max_seqs=2, block_size=4, max_len=16, chunk_size=8)),
    "bf16-pool": dict(pruned=False, B=2, P=10, gen=4, exact=False,
                      cfg=dict(max_seqs=2, block_size=4, max_len=16,
                               chunk_size=4, cache_dtype="bfloat16")),
}


@pytest.mark.parametrize("case", sorted(ORACLE_CASES))
def test_engine_matches_oracle(case):
    spec = ORACLE_CASES[case]
    _, _, tm, tp = models(spec["pruned"])
    prompt = prompts(tm.cfg.vocab_size, spec["B"], spec["P"], seed=13)
    ref = oracle(tm, tp, prompt, spec["gen"])
    eng, rids, out, stats = serve(tm, tp, prompt, spec["gen"], **spec["cfg"])
    assert all(len(out[r].tokens) == spec["gen"] for r in rids)
    if spec.get("exact", True):
        for b, rid in enumerate(rids):
            assert out[rid].tokens == list(ref[b, spec["P"]:]), (case, b)
    if spec["cfg"]["chunk_size"] > 1:
        assert stats["prefill_chunks"] > 0 and stats["prefill_calls"] > 0
    assert 0 < stats["host_syncs"] == stats["sampling_steps"] \
        <= stats["steps"]
    eng.cache_host.check()


def test_preemption_under_a_small_pool_preserves_outputs():
    _, _, tm, tp = models()
    B, P, gen = 4, 10, 12
    prompt = prompts(tm.cfg.vocab_size, B, P, seed=17)
    ref = oracle(tm, tp, prompt, gen)
    eng, rids, out, _ = serve(tm, tp, prompt, gen, max_seqs=4, block_size=4,
                              max_len=24, num_blocks=13, chunk_size=4,
                              prefix_caching=False)
    assert sum(out[r].preemptions for r in rids) > 0
    for b, rid in enumerate(rids):
        assert out[rid].tokens == list(ref[b, P:])
    assert eng.cache_host.allocator.num_live == 0


def test_shared_prefix_aliases_blocks_and_copies_on_write():
    """Two requests behind a shared 8-token prefix reproduce independent
    decoding while allocating strictly fewer blocks; a request that *is* a
    cached prefix aliases every block and copies the last one on write."""
    _, _, tm, tp = models()
    V = tm.cfg.vocab_size
    rng = np.random.default_rng(19)
    prefix = rng.integers(0, V, size=8)
    # the first request registers the prefix blocks and outlives the
    # second, so the third (admitted into the second's slot) aliases blocks
    # that are still live and must copy the one it writes into
    rows = [np.concatenate([prefix, rng.integers(0, V, size=6)]),
            np.concatenate([prefix, rng.integers(0, V, size=2)]),
            prefix.copy()]
    gen = 5
    refs = [oracle(tm, tp, r[None], gen)[0, len(r):] for r in rows]

    def run(prefix_caching):
        eng = Engine(tm, tp, ServeConfig(max_seqs=2, block_size=4,
                                         max_len=24, chunk_size=4,
                                         prefix_caching=prefix_caching),
                     device="cpu")
        rids = [eng.add_request([int(t) for t in r], max_new_tokens=gen)
                for r in rows]
        out, stats = eng.run()
        return eng, [out[r].tokens for r in rids], stats

    eng_on, toks_on, st_on = run(True)
    eng_off, toks_off, st_off = run(False)
    for got_on, got_off, ref in zip(toks_on, toks_off, refs):
        assert got_on == list(ref) and got_off == list(ref)
    assert eng_on.cache_host.prefix_hits > 0
    assert st_on["cow_copies"] >= 1 and st_off["cow_copies"] == 0
    assert eng_on.cache_host.allocator.total_allocated < \
        eng_off.cache_host.allocator.total_allocated
    assert st_on["prefill_tokens"] < st_off["prefill_tokens"]


def _plan_trace(eng):
    """Record every StepPlan an engine's scheduler hands out."""
    trace, inner = [], eng.scheduler.plan_step

    def plan_step(*a, **k):
        plan = inner(*a, **k)
        al = eng.cache_host.allocator
        trace.append({
            "decode": [s.req.rid for s in plan.decode],
            "prefill": [(s.req.rid, n) for s, n in plan.prefill],
            "copies": [(int(a), int(b)) for a, b in plan.copies],
            "admitted": [s.req.rid for s in plan.admitted],
            "preempted": [s.req.rid for s in plan.preempted],
            "tables": eng.cache_host.tables.tolist(),
            "blocks": (al.num_free, al.num_live, al.num_cached,
                       al.total_allocated, al.total_evictions),
        })
        return plan
    eng.scheduler.plan_step = plan_step
    return trace


@pytest.mark.parametrize("cache_dtype", ["", "int8", "fp8_e4m3"])
def test_quantized_pools_keep_the_scheduler_trace(cache_dtype):
    """Host bookkeeping never looks at pool bytes: the plan trace with
    quantized pools equals the f32 trace step for step (token values may
    differ, lengths cannot)."""
    _, _, tm, tp = models()
    prompt = prompts(tm.cfg.vocab_size, 3, 10, seed=23)

    def run(dt):
        eng = Engine(tm, tp, ServeConfig(max_seqs=2, block_size=4,
                                         max_len=24, chunk_size=4,
                                         cache_dtype=dt,
                                         prefix_caching=False),
                     device="cpu")
        trace = _plan_trace(eng)
        for row in prompt:
            eng.add_request([int(t) for t in row], max_new_tokens=6)
        out, _ = eng.run()
        return eng, trace, out

    eng, trace, out = run(cache_dtype)
    _, base_trace, base_out = run("")
    assert trace == base_trace
    assert all(len(r.tokens) == 6 for r in out.values())
    if cache_dtype:
        assert eng.cache["k"].dtype != torch.float32
        assert eng.cache["k_scale"].dtype == torch.float32
        # the first token of each request comes from a prompt-only history:
        # int8/fp8 noise must not flip a clear argmax — agree on most
        agree = np.mean([out[r].tokens[0] == base_out[r].tokens[0]
                         for r in out])
        assert agree >= 2 / 3
    with pytest.raises(ValueError, match="cache_dtype"):
        Engine(tm, tp, ServeConfig(cache_dtype="int4"), device="cpu")


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
                   chunk_size=4, prefill_budget=6, prefix_caching=False)
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
        assert any(p["copies"] for p in ttrace)

    # every token the port emitted (before forcing) is, by the reference's
    # own logits over the reference's sequence, the argmax or tied with it
    for rid, r in enumerate(rows):
        seq = np.concatenate([r, np.asarray(jout[rid].tokens)])
        logits = np.asarray(jm.forward(
            jp, {"tokens": jnp.asarray(seq[None].astype(np.int32))}))[0]
        at = logits[len(r) - 1:len(r) - 1 + gen]
        assert len(emitted[rid]) == gen
        short = at.max(axis=1) - at[np.arange(gen), emitted[rid]]
        assert short.max() <= 1e-4, (rid, short.max())


def test_one_host_fetch_per_step(monkeypatch):
    _, _, tm, tp = models()
    prompt = prompts(tm.cfg.vocab_size, 3, 9, seed=37)
    eng = Engine(tm, tp, ServeConfig(max_seqs=3, block_size=4, max_len=16,
                                     chunk_size=4), device="cpu")
    for row in prompt:
        eng.add_request([int(t) for t in row], max_new_tokens=4)
    sampling = count_sampling_steps(eng)
    calls = []
    real = torch.Tensor.cpu
    monkeypatch.setattr(torch.Tensor, "cpu",
                        lambda self, *a, **k: (calls.append(1),
                                               real(self, *a, **k))[1])
    steps = 0
    while eng.scheduler.has_work:
        before = len(calls)
        eng.step()
        steps += 1
        assert len(calls) - before <= 1
    # one fetch for every step that samples and none besides (a call that
    # only retires finished requests runs no step)
    assert len(calls) == eng._c["host_syncs"].value == sampling[0]
    assert 0 < sampling[0] <= eng._c["steps"].value <= steps


def test_sampling_greedy_rows_untouched_and_distribution():
    _, _, tm, tp = models()
    eng = Engine(tm, tp, ServeConfig(seed=5), device="cpu")
    N, T = 6000, 0.7
    base = torch.tensor([2.0, 1.0, 0.5, -1.0, 0.0])
    logits = base.repeat(N, 1)
    temps = np.where(np.arange(N) % 2 == 0, 0.0, T).astype(np.float32)
    toks = eng._sample(logits, temps).numpy()
    assert toks.dtype == np.int32
    assert (toks[temps == 0] == 0).all()                 # argmax, untouched
    freq = np.bincount(toks[temps > 0], minlength=5) / (N // 2)
    want = torch.softmax(base / T, dim=0).numpy()
    assert np.abs(freq - want).max() < 0.03              # ~3.5 sigma at n=3000
    again = Engine(tm, tp, ServeConfig(seed=5), device="cpu")
    assert (again._sample(logits, temps).numpy() == toks).all()   # seeded
    greedy_only = eng._sample(logits, np.zeros(N, np.float32))
    assert (greedy_only == 0).all()


def test_engine_without_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, _, tm, tp = models()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(tm, tp, ServeConfig())
    from repro_torch.launch import serve as cli
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--arch", "tinyllama-1.1b", "--reduced"])


def test_cli_serves_on_the_cpu_when_asked(capsys):
    from repro_torch.launch import serve as cli
    cli.main(["--arch", "tinyllama-1.1b", "--reduced", "--requests", "5",
              "--prompt-len", "16", "--gen", "4", "--max-seqs", "2",
              "--block-size", "4", "--chunk-size", "8", "--cache-dtype",
              "int8", "--temperature", "0.7", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "served 5 requests / 20 new tokens" in out
    assert "decode " in out and "tok/s | prefill+decode" in out
    toks, lens = synthetic_prompts(256, 6, 16, seed=0)
    assert lens == [16, 14, 12, 10, 16, 14] and toks.shape == (6, 16)


def test_cli_speculative_serving_with_metrics_and_trace(capsys, tmp_path):
    """``--spec-k`` serves with an L1-pruned draft and prints the acceptance
    line; ``--metrics`` the phase table and the Prometheus text;
    ``--trace-out`` writes a Chrome trace that parses.  A recurrent family
    prints the gate's message and serves dense."""
    import json
    from repro_torch.launch import serve as cli
    trace = tmp_path / "t.json"
    cli.main(["--arch", "tinyllama-1.1b", "--reduced", "--requests", "4",
              "--prompt-len", "16", "--gen", "6", "--max-seqs", "2",
              "--block-size", "4", "--chunk-size", "8", "--spec-k", "3",
              "--draft-ratio", "0.5", "--metrics", "--trace-out",
              str(trace), "--device", "cpu"])
    out = capsys.readouterr().out
    assert "speculative draft: tinyllama-1.1b-reduced-pruned" in out
    assert "served 4 requests / 24 new tokens" in out
    assert "speculative: " in out and "cycles | acceptance " in out
    assert "-- step phases (per-step wall, us) --" in out
    for name in ("step", "plan", "decode_dispatch", "sync", "fold"):
        assert f"\n{name} " in out, name
    assert "repro_serve_spec_cycles_total" in out
    assert "repro_spec_accepted_per_cycle_bucket" in out
    doc = json.loads(trace.read_text())
    phs = {e["ph"] for e in doc["traceEvents"]}
    assert {"M", "X", "b", "e", "C"} <= phs
    cli.main(["--arch", "mamba2-1.3b", "--reduced", "--requests", "2",
              "--prompt-len", "8", "--gen", "3", "--spec-k", "3",
              "--device", "cpu"])
    out = capsys.readouterr().out
    assert "speculative decoding gated off for this family" in out
    assert "served 2 requests / 6 new tokens" in out
    assert "speculative: " not in out


def test_port_imports_without_jax_or_the_jax_package():
    """Every module of ``repro_torch`` and ``chip_smoke`` imports with
    ``jax`` and ``repro`` blocked."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None; sys.modules['jaxlib'] = None\n"
        "sys.modules['repro'] = None\n"
        "import importlib, pkgutil, repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "import chip_smoke\n"
        "assert not [k for k, m in sys.modules.items() if m is not None "
        "and k.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
        "print('imported', len(names))\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert int(r.stdout.split()[-1]) >= 20


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_a_gpu(where, tmp_path):
    """No CUDA device (or no repository around the script): a non-zero exit
    code and no result line."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cwd = REPO
    if where == "alone":
        shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
        cwd = str(tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
