"""The port's crash safety under seeded fault schedules, mirroring
``tests/test_serve_chaos.py`` — in both driving modes wherever the reference
parametrizes them — and the engine-level cases of
``tests/test_serve_properties.py`` (the fixed fault schedule, and the
scheduler conservation loop run over the port's copies of the host core).

Every chaos test drives the same requests twice — once fault-free, once under
a deterministic ``FaultInjector`` schedule — and asserts the crash-safety
contract: no deadlock (a hard step bound), no leaked blocks (zero live and
zero held at drain, ``PagedCache.check()`` clean), every request a fault did
not touch byte-identical to the fault-free run, and ``fired`` proving the
schedule exercised what the test claims.  Deadlines, slow steps and load
shedding run on a patched clock in the engine module, never on ``sleep``.

Across frameworks (the last test) one step-pinned schedule runs on the
port's engine and the JAX package's, on converted weights: identical plans,
finish reasons and fault counters, the port's tokens teacher-forced onto the
reference's and each within 1e-4 of the reference's maximum.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as j_get_config, reduced as j_reduced
from repro.models import build as j_build
from repro.serve import (Engine as JEngine, Fault as JFault,
                         FaultInjector as JFaultInjector,
                         ServeConfig as JServeConfig)
import test_serve_properties as j_props
from repro_torch import convert
from repro_torch.configs import get_config, reduced
from repro_torch.models import build
from repro_torch.obs import Telemetry
from repro_torch.serve import (CrashError, Engine, EngineOverloaded, Fault,
                               FaultInjector, ServeConfig, restore_into)
from repro_torch.serve import engine as engine_mod
from repro_torch.serve import kv_cache as t_kv, scheduler as t_sched
from test_torch_engine import _plan_trace
from test_torch_serve_async import FakeClock

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

_MODELS: dict = {}


@pytest.fixture(autouse=True)
def one_thread():
    """Many small products: one intra-op thread under the test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def clock(monkeypatch):
    c = FakeClock()
    monkeypatch.setattr(engine_mod, "time", c)
    return c


def _model():
    if "port" not in _MODELS:
        m = build(reduced(get_config("tinyllama-1.1b")))
        _MODELS["port"] = (m, m.init(0, device="cpu"))
    return _MODELS["port"]


def _prompts(V, n=5, base=10, seed=29):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(0, V, base - (i % 4))]
            for i in range(n)]


def _cfg(**kw):
    kw.setdefault("max_seqs", 3)
    kw.setdefault("block_size", 4)
    kw.setdefault("num_blocks", 48)
    kw.setdefault("max_len", 48)
    kw.setdefault("chunk_size", 8)
    return ServeConfig(**kw)


def _engine(**kw):
    m, params = _model()
    return Engine(m, params, _cfg(**kw), device="cpu")


def _finish(eng, use_async=False, max_steps=400):
    n = 0
    while eng.scheduler.has_work or eng.pending_step:
        (eng.step_async if use_async else eng.step)()
        n += 1
        assert n <= max_steps, f"no progress after {n} steps: deadlock"
    return {r: (tuple(rec.tokens), rec.finish_reason)
            for r, rec in eng.pop_finished().items()}


def _no_leaks(eng):
    a = eng.cache_host.allocator
    assert a.num_live == 0, f"leaked {a.num_live} live blocks"
    assert a.num_held == 0, f"leaked {a.num_held} held blocks"
    eng.cache_host.check()


def _drive(eng, prompts, use_async=False, gen=8, faults=None, **kw):
    """One full drive on a reset engine; returns {rid: (tokens, reason)}
    after asserting the shared crash-safety postconditions."""
    eng.reset()
    eng.faults = faults
    for p in prompts:
        eng.add_request(p, max_new_tokens=gen, **kw)
    out = _finish(eng, use_async)
    eng.faults = None
    _no_leaks(eng)
    return out


MODES = pytest.mark.parametrize("use_async", [False, True],
                                ids=["lockstep", "async"])


# ---------------------------------------------------------------------------
# Allocator exhaustion (alloc_hold pressure)
# ---------------------------------------------------------------------------

@MODES
def test_alloc_exhaustion_byte_identical(use_async):
    """Holding most of the free pool mid-run forces preemption / unjam
    paths, but once the holds expire every request finishes with exactly
    the fault-free tokens."""
    eng = _engine(num_blocks=24, audit_level="full")
    prompts = _prompts(eng.model.cfg.vocab_size)
    ref = _drive(eng, prompts, use_async)
    fi = FaultInjector([
        Fault("alloc_hold", step=1, blocks=10, hold_steps=2),
        Fault("alloc_hold", rate=0.3, times=3, hold_steps=2),
    ], seed=0)
    got = _drive(eng, prompts, use_async, faults=fi)
    assert fi.fired["alloc_hold"] >= 1
    assert got == ref
    assert eng._c["faults_injected"].value >= 1


def test_alloc_exhaustion_total_hold_unjams():
    """Holding the ENTIRE free pool cannot deadlock the engine: plan's
    OutOfBlocks path hands injected holds back (``_unjam``)."""
    eng = _engine(num_blocks=20, audit_level="full")
    prompts = _prompts(eng.model.cfg.vocab_size)
    ref = _drive(eng, prompts)
    fi = FaultInjector([Fault("alloc_hold", step=2, blocks=20,
                              hold_steps=50)], seed=0)
    got = _drive(eng, prompts, faults=fi)
    assert fi.fired["alloc_hold"] == 1
    assert got == ref


# ---------------------------------------------------------------------------
# A user on_token callback raises
# ---------------------------------------------------------------------------

@MODES
def test_injected_callback_error_isolated(use_async):
    """An injected exception inside one request's on_token callback fails
    THAT request ("error") and leaves every other byte-identical."""
    eng = _engine()
    prompts = _prompts(eng.model.cfg.vocab_size)
    ref = _drive(eng, prompts, use_async)
    victim = 1
    seen: dict[int, list] = {r: [] for r in range(len(prompts))}
    eng.reset()
    fi = FaultInjector([Fault("callback_error", rate=1.0, times=1,
                              rid=victim)], seed=0)
    eng.faults = fi
    for r, p in enumerate(prompts):
        eng.add_request(p, max_new_tokens=8,
                        on_token=lambda t, d, r=r: seen[r].append((t, d)))
    got = _finish(eng, use_async)
    eng.faults = None
    assert fi.fired["callback_error"] == 1
    assert eng._c["callback_errors"].value == 1
    assert got[victim][1] == "error"
    for r in got:
        if r != victim:
            assert got[r] == ref[r]
            assert [t for t, _ in seen[r]] == list(ref[r][0])
    # the victim's stream terminated with the (None, True) finish call
    assert seen[victim] and seen[victim][-1] == (None, True)
    _no_leaks(eng)


@MODES
def test_real_callback_exception_isolated(use_async):
    """A genuinely raising user callback (no injector) is contained the
    same way: only its request fails, the engine keeps serving."""
    eng = _engine()
    prompts = _prompts(eng.model.cfg.vocab_size)
    ref = _drive(eng, prompts, use_async)

    def bad(tok, done):
        raise RuntimeError("user callback bug")

    eng.reset()
    for r, p in enumerate(prompts):
        eng.add_request(p, max_new_tokens=8,
                        on_token=bad if r == 2 else None)
    got = _finish(eng, use_async)
    assert got[2][1] == "error"
    assert eng._c["callback_errors"].value >= 1
    for r in got:
        if r != 2:
            assert got[r] == ref[r]
    _no_leaks(eng)


# ---------------------------------------------------------------------------
# Transient and fatal fetch errors
# ---------------------------------------------------------------------------

@MODES
def test_sync_error_transient_redo(use_async):
    """A sync failure within the retry budget is invisible: the fetch
    re-reads the same buffer and the run stays byte-identical, counted as
    a recovery and as one more host sync per retry."""
    eng = _engine(audit_level="full")
    prompts = _prompts(eng.model.cfg.vocab_size)
    ref = _drive(eng, prompts, use_async)
    syncs = eng._c["host_syncs"].value
    fi = FaultInjector([Fault("sync_error", step=2, times=1),
                        Fault("sync_error", step=5, times=1)], seed=0)
    got = _drive(eng, prompts, use_async, faults=fi)
    assert fi.fired["sync_error"] == 2
    assert got == ref
    assert eng._c["recoveries"].value == 2
    assert eng._c["host_syncs"].value == syncs + 2


@MODES
def test_sync_error_fatal_fails_cleanly(use_async):
    """A sync failure past every retry aborts that step.  Affected requests
    fail with "error" and tokens that are a prefix of their reference;
    unaffected requests stay byte-identical; nothing leaks and serving
    continues."""
    eng = _engine(audit_level="full")
    prompts = _prompts(eng.model.cfg.vocab_size)
    ref = _drive(eng, prompts, use_async)
    # times=3 exhausts the initial attempt + 2 retries of one step
    fi = FaultInjector([Fault("sync_error", step=3, times=3)], seed=0)
    got = _drive(eng, prompts, use_async, faults=fi)
    assert fi.fired["sync_error"] == 3
    assert set(got) == set(ref)
    for r in got:
        toks, reason = got[r]
        if reason == ref[r][1]:
            assert got[r] == ref[r]
        else:
            assert reason == "error"
            assert toks == ref[r][0][:len(toks)]
    assert eng._c["recoveries"].value >= 1
    # lockstep: the aborted step never happened and is redone; async: the
    # rows waiting on the lost values fail
    assert any(reason == "error" for _, reason in got.values()) == use_async


# ---------------------------------------------------------------------------
# Crash at step K + snapshot/restore
# ---------------------------------------------------------------------------

@MODES
def test_crash_at_step_k_restore_resumes(use_async):
    """Simulated hard crash: snapshot at K1, crash at K2 > K1, restore the
    snapshot into a FRESH engine — the union of results is exactly the
    fault-free run (work between K1 and K2 is replayed)."""
    eng = _engine(audit_level="full")
    prompts = _prompts(eng.model.cfg.vocab_size)
    ref = _drive(eng, prompts, use_async)

    eng.reset()
    fi = FaultInjector([Fault("crash", step=5)], seed=0)
    eng.faults = fi
    for p in prompts:
        eng.add_request(p, max_new_tokens=8)
    snap = None
    with pytest.raises(CrashError):
        for _ in range(400):
            if eng._steps == 3 and snap is None:
                snap = eng.snapshot()
            (eng.step_async if use_async else eng.step)()
    assert snap is not None and fi.fired["crash"] == 1
    assert eng._c["faults_injected"].value == 1

    eng2 = _engine(audit_level="full")
    restore_into(eng2, snap)
    assert _finish(eng2, use_async) == ref
    _no_leaks(eng2)


# ---------------------------------------------------------------------------
# Deadline storm under straggler steps
# ---------------------------------------------------------------------------

def test_deadline_storm_no_deadlock(clock):
    """Slow steps + tight deadlines on the patched clock: expired requests
    finish "deadline" with a prefix of their tokens, survivors finish
    "length" with the reference tokens, nothing leaks."""
    eng = _engine(audit_level="full")
    prompts = _prompts(eng.model.cfg.vocab_size, n=6)
    ref = _drive(eng, prompts, gen=6)
    fi = FaultInjector([Fault("slow_step", rate=0.5, times=20,
                              delay_s=0.03)], seed=0)
    eng.reset()
    eng.faults = fi
    for i, p in enumerate(prompts):
        # half the requests get a deadline shorter than the storm
        eng.add_request(p, max_new_tokens=6,
                        deadline_s=0.05 if i % 2 else None)
    got = _finish(eng)
    eng.faults = None
    assert fi.fired["slow_step"] >= 1
    assert set(got) == set(ref)
    reasons = [reason for _, reason in got.values()]
    assert "deadline" in reasons and "length" in reasons
    for r, (toks, reason) in got.items():
        assert reason in ("length", "deadline")
        if reason == "length":
            assert got[r] == ref[r]
        else:
            assert r % 2 and toks == ref[r][0][:len(toks)]
    _no_leaks(eng)


# ---------------------------------------------------------------------------
# Invariant auditing: corruption detected + recovered
# ---------------------------------------------------------------------------

def _corrupt_refcount(eng):
    a = eng.cache_host.allocator
    b = next(iter(a._ref))
    a._ref[b] += 1                      # phantom reference


def _corrupt_table(eng):
    cache = eng.cache_host
    s = eng.scheduler.running[0]
    cache.tables[s.slot, 0] = cache.tables[s.slot, 0] + 1


def _corrupt_index(eng):
    cache = eng.cache_host
    cache._block_of[(123456789,)] = cache.num_blocks + 7


@pytest.mark.parametrize("corrupt", [_corrupt_refcount, _corrupt_table,
                                     _corrupt_index],
                         ids=["refcount", "table", "prefix-index"])
def test_audit_detects_and_recovers(corrupt):
    """Injected host-state corruption mid-run: the per-step audit detects
    it, recovery rebuilds from authoritative ownership, and the run
    completes byte-identically (refcounts, tables and the index are derived
    state — no token history is lost) without crashing."""
    eng = _engine(audit_level="full")
    prompts = _prompts(eng.model.cfg.vocab_size)
    ref = _drive(eng, prompts)
    eng.reset()
    for p in prompts:
        eng.add_request(p, max_new_tokens=8)
    for _ in range(3):
        eng.step()
    assert eng.scheduler.running, "need live requests to corrupt"
    corrupt(eng)
    got = _finish(eng)
    assert eng._c["audit_violations"].value >= 1
    assert eng._c["recoveries"].value >= 1
    assert got == ref
    _no_leaks(eng)


def test_audit_off_overhead_under_2pct():
    """The reference times ``audit_level="off"`` against a step; here it is
    counted: with auditing off a whole run calls no ``check`` at all (the
    per-step cost is one string compare), with "alloc" the allocator's
    check runs once a step and with "full" the cache's."""
    calls = {"alloc": 0, "full": 0}

    def counting(eng):
        a, c = eng.cache_host.allocator, eng.cache_host
        ia, ic = a.check, c.check

        def alloc_check():
            calls["alloc"] += 1
            ia()

        def cache_check():
            calls["full"] += 1
            ic()
        a.check, c.check = alloc_check, cache_check

    for level in ("off", "alloc", "full"):
        calls.update(alloc=0, full=0)
        eng = _engine(audit_level=level)
        for p in _prompts(eng.model.cfg.vocab_size, n=3):
            eng.add_request(p, max_new_tokens=6)
        counting(eng)
        _finish(eng)
        steps = eng._c["steps"].value
        if level == "off":
            assert calls == {"alloc": 0, "full": 0}
        else:
            assert calls[level] >= steps > 0, (level, calls, steps)


# ---------------------------------------------------------------------------
# Graceful degradation: load shedding is retriable
# ---------------------------------------------------------------------------

def test_degradation_sheds_and_recovers(clock):
    """Sustained pool pressure engages the ladder: aged waiting requests
    shed with the retriable "shed" reason, prefix admission pauses, and
    the ladder disengages once pressure clears — shed requests then
    complete normally on re-submission."""
    eng = _engine(num_blocks=16, degrade=True, shed_queue_age_s=1e-6,
                  pressure_threshold=0.9, pressure_window=1)
    prompts = _prompts(eng.model.cfg.vocab_size, n=6)
    for p in prompts:
        eng.add_request(p, max_new_tokens=6)
    shed: list[int] = []
    paused = []
    n = 0
    while eng.scheduler.has_work or eng.pending_step:
        eng.step()
        paused.append(eng.cache_host.admission_paused)
        n += 1
        assert n <= 400
        for r, rec in eng.pop_finished().items():
            if rec.finish_reason == "shed":
                shed.append(r)
    assert shed, "pressure never shed anything"
    assert any(paused)
    assert eng._c["requests_shed"].value == len(shed)
    # pressure is gone: ticking the ladder disengages it
    for _ in range(eng.cfg.pressure_window + 1):
        eng._degrade_tick()
    assert not eng._degraded
    assert not eng.cache_host.admission_paused
    # shed = retriable: resubmit and finish normally
    rid = eng.add_request(prompts[0], max_new_tokens=6)
    assert _finish(eng)[rid][1] == "length"
    _no_leaks(eng)


def test_spec_k_clamped_to_one_when_degraded():
    """The ladder's middle rung: while degraded the planned speculative K
    is 1 (the device shapes stay (B, spec_k)), and outputs are unchanged."""
    from repro_torch.core.pruner import prune_model
    m, params = _model()
    pr = prune_model(m, params, 0.5, criterion="l1")
    dm = build(pr.cfg)
    eng = Engine(m, params, _cfg(spec_k=3), draft_model=dm,
                 draft_params=pr.params, device="cpu")
    prompts = _prompts(m.cfg.vocab_size, n=3)
    ref = _drive(eng, prompts)
    ks = []
    inner = engine_mod.Engine._spec_decode

    def spy(self, plan, *a):
        ks.extend(s.spec_k_plan for s in plan.spec)
        return inner(self, plan, *a)

    eng._spec_decode = types.MethodType(spy, eng)
    eng.reset()
    eng._degraded = True                      # degrade=False: it stays
    for p in prompts:
        eng.add_request(p, max_new_tokens=8)
    got = _finish(eng)
    assert ks and set(ks) == {1}
    assert got == ref


# ---------------------------------------------------------------------------
# Terminal reasons are observable
# ---------------------------------------------------------------------------

def test_terminal_reasons_distinct_in_trace(clock):
    """Finish spans carry their terminal reason, so a trace distinguishes
    shed / deadline / length; EngineOverloaded backpressure raises instead
    of silently dropping."""
    tel = Telemetry(enabled=True)
    m, params = _model()
    eng = Engine(m, params, _cfg(
        num_blocks=16, max_waiting=2, degrade=True, shed_queue_age_s=1e-6,
        pressure_threshold=0.9, pressure_window=2), telemetry=tel,
        device="cpu")
    prompts = _prompts(m.cfg.vocab_size, n=5)
    for p in prompts[:2]:
        eng.add_request(p, max_new_tokens=8)
    with pytest.raises(EngineOverloaded):
        eng.add_request(prompts[2], max_new_tokens=8)
    eng.step()                          # admits both; queue drains
    # an already-expired deadline -> "deadline" at the next boundary
    eng.add_request(prompts[2], max_new_tokens=8, deadline_s=-1.0)
    # aged waiting request shed once pool pressure engages -> "shed"
    eng.add_request(prompts[3], max_new_tokens=8)
    _finish(eng)
    reasons = {dict(s.meta).get("reason") for s in tel.trace.spans
               if s.kind == "finish"}
    assert {"length", "deadline", "shed"} <= reasons
    assert tel.registry.gauges["pool/degraded"].value in (0.0, 1.0)


# ---------------------------------------------------------------------------
# From tests/test_serve_properties.py
# ---------------------------------------------------------------------------

def test_engine_fixed_fault_schedule_byte_identical(clock):
    """One schedule mixing the three recoverable kinds (pool pressure, a
    transient fetch error, a straggler step) stays byte-identical."""
    eng = _engine(num_blocks=24, audit_level="full")
    prompts = _prompts(eng.model.cfg.vocab_size, n=4, seed=53)
    ref = _drive(eng, prompts, gen=6)
    fi = FaultInjector([Fault("alloc_hold", step=2, blocks=8,
                              hold_steps=2),
                        Fault("sync_error", step=4),
                        Fault("slow_step", step=6, delay_s=0.001)], seed=0)
    assert _drive(eng, prompts, gen=6, faults=fi) == ref
    assert sum(fi.fired.values()) >= 2


# the reference's scheduler loop, run over the port's host core: the same
# code object with the port's classes in its globals
_port_drive_scheduler = types.FunctionType(
    j_props.drive_scheduler.__code__,
    {**j_props.drive_scheduler.__globals__,
     "PagedCache": t_kv.PagedCache, "FCFSScheduler": t_sched.FCFSScheduler,
     "Request": t_sched.Request, "OutOfBlocks": t_kv.OutOfBlocks},
    "drive_scheduler", j_props.drive_scheduler.__defaults__)


@pytest.mark.parametrize("seed", range(10))
def test_scheduler_conservation_under_faults(seed):
    """Fixed fault plans keep the held-block conservation oracle and the
    unjam path exercised over the port's scheduler and cache."""
    _port_drive_scheduler(seed * 31337,
                          fault_plan=((5, 0.5, 3), (40, 1.0, 2),
                                      (80, 0.3, 4)))


# ---------------------------------------------------------------------------
# Across frameworks: one step-pinned schedule on both engines
# ---------------------------------------------------------------------------

def test_fault_schedule_vs_jax_engine():
    """Same weights, same requests, the same step-pinned schedule of every
    engine-scoped kind but the crash (pool pressure, a transient and a
    fatal fetch error, a straggler step, a raising callback): identical
    per-step plans, finish reasons, fault counters and firings; the port's
    tokens, teacher-forced onto the reference's after every step, within
    1e-4 of the reference's maximum at every position."""
    jm = j_build(j_reduced(j_get_config("tinyllama-1.1b")))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build(convert.convert_config(dataclasses.asdict(jm.cfg)))
    tp = convert.convert_params(jax.tree.map(np.asarray, jp))
    rows = _prompts(tm.cfg.vocab_size, n=5, seed=59)
    cfg = dict(max_seqs=3, block_size=4, num_blocks=24, max_len=48,
               chunk_size=8, audit_level="full")
    gen = 8

    def schedule(F):
        return [F("alloc_hold", step=2, blocks=10, hold_steps=2),
                F("sync_error", step=4),
                F("sync_error", step=6, times=3),
                F("slow_step", step=7, delay_s=0.001),
                F("callback_error", step=5, rid=1)]

    counters = ("faults_injected", "recoveries", "callback_errors",
                "audit_violations", "steps", "host_syncs", "decode_tokens")

    jfi = JFaultInjector(schedule(JFault), seed=0)
    jeng = JEngine(jm, jp, JServeConfig(**cfg), faults=jfi)
    jtrace = _plan_trace(jeng)
    for r in rows:
        jeng.add_request(r, max_new_tokens=gen, on_token=lambda t, d: None)
    jout, jstats = jeng.run()

    tfi = FaultInjector(schedule(Fault), seed=0)
    teng = Engine(tm, tp, ServeConfig(**cfg), device="cpu", faults=tfi)
    ttrace = _plan_trace(teng)
    for r in rows:
        teng.add_request(r, max_new_tokens=gen, on_token=lambda t, d: None)
    emitted: dict[int, list[int]] = {i: [] for i in range(len(rows))}
    while teng.scheduler.has_work or teng.pending_step:
        for s in teng.step():                   # teacher forcing: go on
            rid, n = s.req.rid, len(s.generated)    # from JAX's tokens
            emitted[rid].extend(s.generated[len(emitted[rid]):n])
            s.generated[:] = jout[rid].tokens[:n]
    tout = teng.pop_finished()

    assert dict(tfi.fired) == dict(jfi.fired)
    assert tfi.fired["sync_error"] == 4 and tfi.fired["callback_error"] == 1
    assert len(ttrace) == len(jtrace)
    for i, (a, b) in enumerate(zip(ttrace, jtrace)):
        assert a == b, f"plan {i} differs"
    for k in counters:
        assert teng._c[k].value == jeng._c[k].value, k
    assert {r: x.finish_reason for r, x in tout.items()} == \
        {r: x.finish_reason for r, x in jout.items()}
    assert tout[1].finish_reason == "error"
    # one forward over the right-padded sequences (causal: a row's logits
    # do not see its padding)
    seqs = [list(r) + jout[rid].tokens for rid, r in enumerate(rows)]
    batch = np.zeros((len(seqs), max(map(len, seqs))), np.int32)
    for i, q in enumerate(seqs):
        batch[i, :len(q)] = q
    logits = np.asarray(jm.forward(jp, {"tokens": jnp.asarray(batch)}))
    for rid, r in enumerate(rows):
        n = len(jout[rid].tokens)
        at = logits[rid, len(r) - 1:len(r) - 1 + n]
        assert len(emitted[rid]) == n == len(tout[rid].tokens)
        short = at.max(axis=1) - at[np.arange(n), emitted[rid]]
        assert short.max() <= 1e-4, (rid, short.max())
