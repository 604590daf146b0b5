"""The port's double-buffered ``step_async`` and its serving front door,
mirroring ``tests/test_serve_async.py`` (its two sharded tests wait for the
port's meshes): async / lockstep / oracle token parity across engine
configurations, streaming callbacks and the ``stream`` iterator,
cancellation, deadlines, backpressure, ``pop_finished``, and a randomized
stop-and-cancel loop that exercises the predicted-state rollback.

Within the port every comparison is exact: the async engine, the lockstep
engine and the sequential oracle (``generate``) run the same f32 arithmetic
on the CPU.  Across frameworks (the last test) the port's async engine and
the JAX package's, on converted weights, must make identical per-step plans
and counters; their tokens are compared after asserting the reference's
top-2 logit gap at every emitted position, as ``test_torch_spec_jax.py``
does, and each emitted token is held to the reference's teacher-forced
maximum within 1e-4.  Deadlines run on a patched clock in the engine module.
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
from repro_torch.configs import get_config, reduced
from repro_torch.core.pruner import prune_model
from repro_torch.launch.serve import generate
from repro_torch.models import build
from repro_torch.obs import Telemetry
from repro_torch.serve import Engine, EngineOverloaded, ServeConfig
from repro_torch.serve import engine as engine_mod
from test_torch_engine import _plan_trace, count_sampling_steps

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# the top-2 gap every deciding choice must clear: f32 logits of the two
# frameworks differ by ~1e-6 at these widths
MARGIN = 1e-4
_MODELS: dict = {}


@pytest.fixture(autouse=True)
def one_thread():
    """Many small products: one intra-op thread under the test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class FakeClock:
    """A deterministic stand-in for the engine module's ``time``: every
    reading advances it by ``tick`` seconds, ``sleep`` by its argument."""

    def __init__(self, tick: float = 1e-3):
        self.t, self.tick = 1000.0, tick

    def time(self) -> float:
        self.t += self.tick
        return self.t

    perf_counter = time

    def sleep(self, s: float) -> None:
        self.t += s


def _model(pruned_ratio: float = 0.0):
    """(model, params) of reduced TinyLlama from the port's own init (seed
    0); with ``pruned_ratio``, L1-pruned by the port's pruner."""
    if pruned_ratio not in _MODELS:
        m = build(reduced(get_config("tinyllama-1.1b")))
        params = m.init(0, device="cpu")
        if pruned_ratio:
            pr = prune_model(m, params, pruned_ratio, criterion="l1")
            m, params = build(pr.cfg), pr.params
        _MODELS[pruned_ratio] = (m, params)
    return _MODELS[pruned_ratio]


def _prompts(V, n=5, base=10, seed=13):
    """``n`` prompts of lengths ``base - (i % 4)`` (the reference's mix)."""
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(0, V, base - (i % 4))]
            for i in range(n)]


def _engine(**cfg):
    m, params = _model()
    return Engine(m, params, ServeConfig(**cfg), device="cpu")


def _drive(eng, prompts, use_async, gen=8, check=True, **kw):
    """Drive one run in the chosen mode on a reset engine; returns the
    finished records.  The async drain condition includes
    ``pending_step`` for the last in-flight reconcile."""
    eng.reset()
    for p in prompts:
        eng.add_request(p, max_new_tokens=gen, **kw)
    step = eng.step_async if use_async else eng.step
    n = 0
    while eng.scheduler.has_work or eng.pending_step:
        step()
        n += 1
        assert n <= 400, "no progress"
        if check:
            eng.cache_host.check()
    return eng.pop_finished()


def _serve(eng, prompts, use_async, gen=8, check=True, **kw):
    """{rid: (tokens, finish_reason)} of one drive."""
    return {r: (tuple(rec.tokens), rec.finish_reason)
            for r, rec in _drive(eng, prompts, use_async, gen, check,
                                 **kw).items()}


def _oracle(prompt, gen, stops=()):
    """The sequential oracle's tokens for one prompt, cut after the first
    stop token, and the finish reason that implies."""
    m, params = _model()
    with torch.no_grad():
        row = generate(m, params, torch.tensor([prompt]), gen)[0]
    toks = [int(t) for t in row[len(prompt):]]
    for i, t in enumerate(toks):
        if t in stops:
            return tuple(toks[:i + 1]), "stop"
    return tuple(toks), "length"


# ---------------------------------------------------------------------------
# Parity: async == lockstep == the sequential oracle
# ---------------------------------------------------------------------------

PARITY = {
    "dense": dict(cfg=dict(max_seqs=3, block_size=4, max_len=32,
                           chunk_size=4), n=5, base=10, gen=8),
    # a stop token lands while the next predicted step is already in
    # flight: reconcile cancels the in-flight row and truncates the
    # speculatively grown blocks
    "stop-tokens": dict(cfg=dict(max_seqs=3, block_size=4, max_len=48,
                                 chunk_size=4), n=4, base=10, gen=10),
    # a pool too small for every request: the overlap gate must prove
    # headroom or fall back to lockstep
    "preemption": dict(cfg=dict(max_seqs=4, block_size=4, max_len=64,
                                num_blocks=13), n=4, base=9, gen=12),
    "prefill-budget": dict(cfg=dict(max_seqs=3, block_size=4, max_len=32,
                                    chunk_size=4, prefill_budget=6),
                           n=5, base=10, gen=8),
    "token-by-token": dict(cfg=dict(max_seqs=3, block_size=4, max_len=32,
                                    chunk_size=0), n=5, base=10, gen=8),
    # the oracle holds an f32 contiguous cache: int8 pools are held to
    # the lockstep engine only
    "int8": dict(cfg=dict(max_seqs=2, block_size=4, max_len=32,
                          chunk_size=4, cache_dtype="int8"),
                 n=3, base=10, gen=8, oracle=False),
}


@pytest.mark.parametrize("case", sorted(PARITY))
def test_async_lockstep_and_oracle_agree(case):
    spec = PARITY[case]
    eng = _engine(**spec["cfg"])
    ps = _prompts(eng.model.cfg.vocab_size, spec["n"], spec["base"])
    gen, stops = spec["gen"], ()
    if case == "stop-tokens":
        # stop on a token each request actually emits mid-stream
        base = _serve(eng, ps, False, gen)
        stops = tuple(sorted({toks[3] for toks, _ in base.values()}))
    recs = _drive(eng, ps, False, gen, stop_tokens=stops)
    ref = {r: (tuple(x.tokens), x.finish_reason) for r, x in recs.items()}
    out = _serve(eng, ps, True, gen, stop_tokens=stops)
    assert out == ref
    if spec.get("oracle", True):
        for r, p in enumerate(ps):
            assert ref[r] == _oracle(p, gen, stops), (case, r)
    if case == "stop-tokens":
        assert any(reason == "stop" for _, reason in out.values())
    if case == "preemption":
        assert sum(x.preemptions for x in recs.values()) > 0
    if case == "int8":
        assert eng.cache["k"].dtype == torch.int8


def test_async_parity_matches_sequential_oracle():
    """run() drives step_async when ``async_step``; more requests than
    slots, equal-length prompts against one batched oracle call."""
    m, params = _model()
    B, P, GEN = 3, 9, 8
    prompt = np.random.default_rng(3).integers(0, m.cfg.vocab_size,
                                               size=(B, P))
    with torch.no_grad():
        ref = generate(m, params, torch.from_numpy(prompt), GEN).numpy()
    eng = Engine(m, params, ServeConfig(max_seqs=2, block_size=4,
                                        max_len=32, async_step=True),
                 device="cpu")
    for b in range(B):
        eng.add_request([int(t) for t in prompt[b]], max_new_tokens=GEN)
    out, stats = eng.run()
    for b in range(B):
        assert out[b].tokens == list(ref[b, P:])
    assert stats["decode_tokens"] == B * GEN


def test_async_spec_decode_falls_back_to_lockstep():
    """Speculative growth is value-dependent (acceptance counts ride the
    fetch), so async driving must lockstep — and still match lockstep
    token for token with stop tokens in play."""
    m, params = _model()
    dm, dp = _model(0.5)
    eng = Engine(m, params, ServeConfig(max_seqs=2, block_size=4,
                                        max_len=48, spec_k=3),
                 draft_model=dm, draft_params=dp, device="cpu")
    assert eng.spec_active
    folds = []
    eng._predict_fold = lambda rec: folds.append(rec)
    ps = _prompts(m.cfg.vocab_size, n=3)
    ref = _serve(eng, ps, False, gen=10)
    stops = tuple(sorted({toks[4] for toks, _ in ref.values()}))
    a = _serve(eng, ps, False, gen=10, stop_tokens=stops)
    b = _serve(eng, ps, True, gen=10, stop_tokens=stops)
    assert a == b
    assert not folds                      # never overlapped


def test_async_overlap_engages_and_is_observable():
    """Steady decode with pool headroom must take the overlap path
    (phase/overlap recorded, one fetch for every step that samples), and
    the bubble-fraction gauge must be sampled."""
    m, params = _model()
    tel = Telemetry(enabled=True)
    eng = Engine(m, params, ServeConfig(max_seqs=2, block_size=4,
                                        max_len=32, chunk_size=4),
                 telemetry=tel, device="cpu")
    sampling = count_sampling_steps(eng)
    for p in _prompts(m.cfg.vocab_size, n=2):
        eng.add_request(p, max_new_tokens=8)
    while eng.scheduler.has_work or eng.pending_step:
        eng.step_async()
    hists = tel.registry.histograms
    assert hists["phase/overlap"].count > 0
    assert hists["phase/step"].count >= hists["phase/overlap"].count
    assert eng._c["host_syncs"].value == sampling[0] > 0
    assert 0.0 <= tel.registry.gauges["engine/bubble_fraction"].value <= 1.0


def test_mixed_step_and_step_async_driving():
    """Interleaving the two step functions is safe: step() reconciles any
    in-flight async step before planning."""
    eng = _engine(max_seqs=2, block_size=4, max_len=32)
    ps = _prompts(eng.model.cfg.vocab_size, n=3)
    ref = _serve(eng, ps, False)
    eng.reset()
    for p in ps:
        eng.add_request(p, max_new_tokens=8)
    i = 0
    while eng.scheduler.has_work or eng.pending_step:
        (eng.step_async if i % 3 else eng.step)()
        i += 1
    out = {r: (tuple(rec.tokens), rec.finish_reason)
           for r, rec in eng.pop_finished().items()}
    assert out == ref


def test_feed_tokens_stay_on_the_device():
    """Under overlap a pending token reaches the next step from the
    previous step's device tensor, never through the host: the token
    array the host builds holds 0 in the fed rows, and the feed masks
    ride in the call's one upload."""
    eng = _engine(max_seqs=2, block_size=4, max_len=32, chunk_size=4)
    uploads = []
    inner = eng._upload

    def spy(*arrays):
        uploads.append([a.copy() for a in arrays])
        return inner(*arrays)

    eng._upload = spy
    ps = _prompts(eng.model.cfg.vocab_size, n=2)
    ref = _serve(eng, ps, False)
    uploads.clear()
    assert _serve(eng, ps, True) == ref
    # decode uploads: tokens, positions, tables, then the feed masks
    fed = [u for u in uploads if u[0].ndim == 1 and len(u) > 3]
    assert fed
    for u in fed:
        mask = np.zeros(2, bool)
        for m_ in u[3:]:
            mask |= m_.astype(bool)
        assert mask.any() and (u[0][mask] == 0).all()


# ---------------------------------------------------------------------------
# Streaming, cancellation, deadlines, backpressure
# ---------------------------------------------------------------------------

def test_streaming_callback_order_async():
    eng = _engine(max_seqs=2, block_size=4, max_len=32, async_step=True)
    seen = []
    prompt = _prompts(eng.model.cfg.vocab_size, n=1)[0]
    rid = eng.add_request(prompt, max_new_tokens=7,
                          on_token=lambda t, d: seen.append((t, d)))
    out, _ = eng.run()
    assert [t for t, _ in seen] == out[rid].tokens
    assert [d for _, d in seen] == [False] * 6 + [True]


def test_stream_iterator():
    eng = _engine(max_seqs=2, block_size=4, max_len=32, async_step=True)
    prompt = _prompts(eng.model.cfg.vocab_size, n=1)[0]
    ref = _serve(eng, [prompt], False, gen=6)
    toks = list(eng.stream(prompt, max_new_tokens=6))
    assert tuple(toks) == next(iter(ref.values()))[0]


def test_cancel_running_mid_flight():
    """Cancel while the request's next sample is in flight: the in-flight
    token is discarded, blocks are truncated, and the partial output is a
    prefix of the uncancelled run."""
    eng = _engine(max_seqs=2, block_size=4, max_len=48)
    prompt = _prompts(eng.model.cfg.vocab_size, n=1)[0]
    full_toks = next(iter(_serve(eng, [prompt], False, gen=12).values()))[0]

    eng.reset()
    fired = []
    rid = eng.add_request(prompt, max_new_tokens=12,
                          on_token=lambda t, d: fired.append((t, d)))
    for _ in range(6):
        eng.step_async()
    assert eng.pending_step
    assert eng.cancel(rid)
    while eng.scheduler.has_work or eng.pending_step:
        eng.step_async()
    eng.cache_host.check()
    rec = eng.pop_finished()[rid]
    assert rec.finish_reason == "cancelled"
    assert 0 < len(rec.tokens) < 12
    assert tuple(rec.tokens) == full_toks[:len(rec.tokens)]
    assert fired[-1] == (None, True)       # tokenless finish notification


def test_cancel_waiting_before_admission():
    eng = _engine(max_seqs=1, block_size=4, max_len=32)
    p1, p2 = _prompts(eng.model.cfg.vocab_size, n=2)
    eng.add_request(p1, max_new_tokens=6)
    r2 = eng.add_request(p2, max_new_tokens=6)   # waits: one slot only
    assert eng.cancel(r2)
    assert not eng.cancel(r2)                    # already finished
    out, _ = eng.run()
    assert out[r2].tokens == [] and out[r2].finish_reason == "cancelled"


def test_cancel_is_idempotent_for_unknown_and_finished():
    """cancel() is safe with anything: unknown rids, rids that already
    finished, repeats — all return False without touching engine state."""
    eng = _engine(max_seqs=2, block_size=4, max_len=32)
    assert not eng.cancel(0)                     # never submitted
    assert not eng.cancel(999)
    rid = eng.add_request(_prompts(eng.model.cfg.vocab_size, n=1)[0],
                          max_new_tokens=4)
    out, _ = eng.run()
    assert out[rid].finish_reason == "length"
    assert not eng.cancel(rid)                   # finished + retired
    assert not eng.cancel(rid)                   # still False on repeat
    eng.cache_host.check()


def test_cancel_during_prefill_chunk():
    """Cancel a request mid-chunked-prefill: the remaining chunks never
    dispatch, its blocks free fully, and other requests are unaffected."""
    eng = _engine(max_seqs=2, block_size=4, max_len=64, chunk_size=4)
    V = eng.model.cfg.vocab_size
    long_p = [int(t) for t in np.random.default_rng(5).integers(0, V, 24)]
    short_p = _prompts(V, n=1)[0]
    ref = _serve(eng, [short_p], False, gen=6)

    eng.reset()
    victim = eng.add_request(long_p, max_new_tokens=6)
    other = eng.add_request(short_p, max_new_tokens=6)
    eng.step()                        # first prefill chunk only (4 < 24)
    assert eng.cancel(victim)
    assert not eng.cancel(victim)                # idempotent
    while eng.scheduler.has_work or eng.pending_step:
        eng.step()
    out = eng.pop_finished()
    assert out[victim].finish_reason == "cancelled"
    assert out[victim].tokens == []
    assert (tuple(out[other].tokens), out[other].finish_reason) \
        == ref[next(iter(ref))]
    assert eng.cache_host.allocator.num_live == 0
    eng.cache_host.check()


@pytest.mark.parametrize("use_async", [False, True],
                         ids=["lockstep", "async"])
def test_deadline_expiry(monkeypatch, use_async):
    """On a patched clock: a request queued behind another with a zero
    budget expires at the first step boundary, before it holds blocks;
    one admitted with a short budget expires mid-flight with a prefix of
    its tokens."""
    monkeypatch.setattr(engine_mod, "time", FakeClock())
    eng = _engine(max_seqs=1, block_size=4, max_len=32,
                  async_step=use_async)
    p1, p2 = _prompts(eng.model.cfg.vocab_size, n=2)
    full = _serve(eng, [p1], use_async)[0][0]
    eng.reset()
    r1 = eng.add_request(p1, max_new_tokens=8, deadline_s=0.008)
    r2 = eng.add_request(p2, max_new_tokens=8, deadline_s=0.0)
    out, _ = eng.run()
    assert out[r2].finish_reason == "deadline" and out[r2].tokens == []
    assert out[r1].finish_reason == "deadline"
    assert 0 < len(out[r1].tokens) < 8
    assert tuple(out[r1].tokens) == full[:len(out[r1].tokens)]
    assert eng.cache_host.allocator.num_live == 0


def test_backpressure_overload():
    eng = _engine(max_seqs=1, block_size=4, max_len=32, max_waiting=2)
    ps = _prompts(eng.model.cfg.vocab_size, n=3)
    eng.add_request(ps[0], max_new_tokens=4)
    eng.add_request(ps[1], max_new_tokens=4)
    with pytest.raises(EngineOverloaded):
        eng.add_request(ps[2], max_new_tokens=4)
    eng.run()                                    # queue drains fine
    eng.add_request(ps[2], max_new_tokens=4)     # room again
    out, _ = eng.run()
    assert len(out) == 1


def test_pop_finished_bounds_host_state():
    eng = _engine(max_seqs=2, block_size=4, max_len=32)
    for p in _prompts(eng.model.cfg.vocab_size, n=3):
        eng.add_request(p, max_new_tokens=4, on_token=lambda t, d: None,
                        deadline_s=60.0)
    while eng.scheduler.has_work or eng.pending_step:
        eng.step_async()
    assert len(eng.finished()) == 3              # non-destructive
    recs = eng.pop_finished()
    assert len(recs) == 3
    assert not eng.scheduler.finished
    assert not eng._submit_wall and not eng._on_token and not eng._deadline


# ---------------------------------------------------------------------------
# Property-style rollback test
# ---------------------------------------------------------------------------

def test_async_random_stop_and_cancel_property():
    """Randomized stop tokens + mid-run cancels under async driving: every
    surviving output matches the lockstep run, a cancelled one is a prefix
    of it, the pool invariants hold on every step, and nothing leaks."""
    eng = _engine(max_seqs=3, block_size=4, max_len=48, chunk_size=4)
    V = eng.model.cfg.vocab_size
    prng = np.random.default_rng(29)
    for round_ in range(3):
        ps = _prompts(V, n=5, seed=100 + round_)
        stops = tuple(int(t) for t in prng.integers(0, V, 2))
        ref = _serve(eng, ps, False, gen=10, stop_tokens=stops)

        eng.reset()
        rids = [eng.add_request(p, max_new_tokens=10, stop_tokens=stops)
                for p in ps]
        cancel_at = {int(prng.integers(2, 10)): int(r)
                     for r in prng.choice(rids, 2, replace=False)}
        i = 0
        while eng.scheduler.has_work or eng.pending_step:
            if i in cancel_at:
                eng.cancel(cancel_at[i])
            eng.step_async()
            eng.cache_host.check()
            i += 1
        out = eng.pop_finished()
        assert set(out) == set(rids)
        for r in rids:
            toks, reason = tuple(out[r].tokens), out[r].finish_reason
            if reason == "cancelled":
                assert toks == ref[r][0][:len(toks)]
            else:
                assert (toks, reason) == ref[r], (round_, r)
        assert eng.cache_host.allocator.num_live == 0


# ---------------------------------------------------------------------------
# Across frameworks: the port's async engine against the JAX async engine
# ---------------------------------------------------------------------------

def _jax_models():
    """(JAX model, JAX params, port model, port params) of reduced
    TinyLlama from PRNGKey(0), the port's weights converted."""
    if "jax" not in _MODELS:
        jm = j_build(j_reduced(j_get_config("tinyllama-1.1b")))
        jp = jm.init(jax.random.PRNGKey(0))
        tm = build(convert.convert_config(dataclasses.asdict(jm.cfg)))
        tp = convert.convert_params(jax.tree.map(np.asarray, jp))
        _MODELS["jax"] = (jm, jp, tm, tp)
    return _MODELS["jax"]


def _count_folds(eng) -> list:
    """Count the engine's predicted folds (steps that overlapped)."""
    n, inner = [0], eng._predict_fold

    def counted(rec):
        n[0] += 1
        return inner(rec)
    eng._predict_fold = counted
    return n


def test_async_engine_vs_jax_async_engine():
    """Same weights, same requests (three behind a shared 8-token prefix,
    so prefix hits and copy-on-write happen under overlap), both engines
    driven by ``step_async``: identical per-step plans, block accounting,
    counters and overlapped steps; tokens equal once every emitted
    position's reference top-2 gap is asserted, each within 1e-4 of the
    reference's teacher-forced maximum."""
    jm, jp, tm, tp = _jax_models()
    V = tm.cfg.vocab_size
    rng = np.random.default_rng(31)
    prefix = rng.integers(0, V, size=8)
    rows = [np.concatenate([prefix, rng.integers(0, V, size=n)])
            for n in (6, 2, 0)] + [rng.integers(0, V, size=9)]
    cfg = dict(max_seqs=2, block_size=4, max_len=24, chunk_size=4,
               async_step=True)
    gen = 6

    def serve(eng):
        trace, folds = _plan_trace(eng), _count_folds(eng)
        for r in rows:
            eng.add_request([int(t) for t in r], max_new_tokens=gen)
        out, stats = eng.run()
        return out, stats, trace, folds[0]

    jout, jstats, jtrace, jfolds = serve(JEngine(jm, jp, JServeConfig(**cfg)))
    # one forward over the right-padded sequences (causal: a row's logits
    # do not see its padding)
    batch = np.zeros((len(rows), max(map(len, rows)) + gen), np.int32)
    for rid, r in enumerate(rows):
        batch[rid, :len(r) + gen] = np.concatenate([r, jout[rid].tokens])
    lg = np.asarray(jm.forward(jp, {"tokens": jnp.asarray(batch)}))
    logits = []
    for rid, r in enumerate(rows):
        at = lg[rid, len(r) - 1:len(r) - 1 + gen]
        top = np.sort(at, axis=-1)
        assert (top[:, -1] - top[:, -2]).min() > MARGIN, rid
        logits.append(at)

    tout, tstats, ttrace, tfolds = serve(
        Engine(tm, tp, ServeConfig(**cfg), device="cpu"))
    assert jfolds == tfolds > 0
    assert len(ttrace) == len(jtrace)
    for i, (a, b) in enumerate(zip(ttrace, jtrace)):
        assert a == b, f"plan {i} differs"
    assert any(p["copies"] for p in ttrace)
    for k in ("steps", "prefill_chunks", "prefill_tokens", "decode_tokens",
              "cow_copies", "host_syncs"):
        assert tstats[k] == jstats[k], k
    for rid, at in enumerate(logits):
        assert tout[rid].tokens == jout[rid].tokens, rid
        short = at.max(axis=1) - at[np.arange(gen), tout[rid].tokens]
        assert short.max() <= 1e-4, (rid, short.max())
