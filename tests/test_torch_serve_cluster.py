"""The port's replicated serving (``repro_torch.serve.cluster``) and the
engine's hand-off surface, mirroring ``tests/test_serve_cluster.py``.

The contract under test: a :class:`Cluster` of engine replicas survives
replica death and rolling restarts without changing a single output token.
Every test drives a request set once on a single engine for a reference,
then on a cluster under a failure scenario, and asserts:

  - every in-flight request completes on survivors with tokens identical to
    the single-engine run (per-request outputs are batch- and
    placement-independent at temperature 0; within the port every
    comparison is exact, the same f32 arithmetic on the CPU);
  - zero leaked or held blocks on every surviving allocator, and the full
    conservation oracle ``PagedCache.check()`` passes;
  - the cluster's health / failover counters prove the scenario happened
    (``fired``, ``failovers``, ``migrated_blocks``).

Besides the mirrored cases: ``discard_inflight`` on an async engine (the
port's in-flight step holds a pinned fetch and feeds tokens on the device),
and, across frameworks on converted weights, a failover run of the port's
cluster against the JAX package's and the reference's two-engine migration
loop (``tests/test_serve_properties.py::_drive_migration``'s fixed
schedules, one of them the case of the reference's known held-block flake:
the port keeps that behaviour, and the test holds the allocator counts to
the reference's after every round).  Host bookkeeping is compared exactly,
the gathered pool bytes within 1e-5, and tokens after the reference's top-2
logit gap is asserted at every position, else each port token is held
within 1e-4 of the reference's teacher-forced maximum.  The engine and the
cluster read a patched clock (drain deadlines).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as j_get_config, reduced as j_reduced
from repro.models import build as j_build
from repro.serve import (Cluster as JCluster, Engine as JEngine,
                         Fault as JFault, FaultInjector as JFaultInjector,
                         ServeConfig as JServeConfig)
from repro_torch import convert
from repro_torch.configs import get_config, reduced
from repro_torch.core.pruner import prune_model
from repro_torch.models import build
from repro_torch.serve import (AuditViolation, Cluster, ClusterConfig, Engine,
                               Fault, FaultInjector, OutOfBlocks, PagedCache,
                               ServeConfig, adopt_requests, capture_requests,
                               restore_into)
from repro_torch.serve import cluster as cluster_mod
from repro_torch.serve import engine as engine_mod
from test_torch_serve_async import FakeClock

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


@pytest.fixture(autouse=True)
def clock(monkeypatch):
    """The port's engine and cluster read a deterministic clock: drain
    deadlines and hand-off timers cannot depend on the host's speed."""
    fc = FakeClock()
    monkeypatch.setattr(engine_mod, "time", fc)
    monkeypatch.setattr(cluster_mod, "time", fc)
    return fc


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


def _prompts(V, n=6, base=10, seed=37):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(0, V, base - (i % 4))]
            for i in range(n)]


def _cfg(**kw):
    kw.setdefault("max_seqs", 3)
    kw.setdefault("block_size", 4)
    kw.setdefault("num_blocks", 48)
    kw.setdefault("max_len", 48)
    kw.setdefault("chunk_size", 8)
    kw.setdefault("audit_level", "full")
    return ServeConfig(**kw)


def _engine(pruned_ratio: float = 0.0, **kw):
    m, params = _model(pruned_ratio)
    return Engine(m, params, _cfg(**kw), device="cpu")


def _reference(prompts, gen=8, **cfg_kw):
    """Single-engine oracle: {submission index: tokens}."""
    eng = _engine(**cfg_kw)
    for p in prompts:
        eng.add_request(p, max_new_tokens=gen)
    out, _ = eng.run()
    return {i: tuple(out[i].tokens) for i in sorted(out)}


def _drive(cluster, rids, max_ticks=500):
    """Run a cluster dry and assert the shared postconditions: bounded
    ticks, no leaks on survivors, conservation audit clean.  Returns
    ({submission index: (tokens, finish_reason)}, stats)."""
    res, stats = cluster.run(max_ticks=max_ticks)
    assert not cluster.has_work, "cluster deadlocked"
    cluster.check()
    for r in cluster.replicas:
        if r.state == "alive":
            a = r.engine.cache_host.allocator
            assert a.num_live == 0, f"{r.name}: leaked live blocks"
            assert a.num_held == 0, f"{r.name}: leaked held blocks"
    return {rids.index(rid): (tuple(rec.tokens), rec.finish_reason)
            for rid, rec in res.items()}, stats


def _tokens(got):
    return {i: v for i, (v, _) in got.items()}


# ---------------------------------------------------------------------------
# Kill a replica mid-decode: outputs identical
# ---------------------------------------------------------------------------

def test_kill_replica_mid_decode_byte_identical():
    """Replica 0 dies at cluster tick 4 (requests mid-decode on both
    replicas): every request — including replica 0's running set and
    backlog — completes on the survivor with single-engine tokens."""
    m, _ = _model()
    prompts = _prompts(m.cfg.vocab_size)
    ref = _reference(prompts)
    fi = FaultInjector([Fault("replica_kill", step=4, rid=0)])
    cl = Cluster([_engine(), _engine()], faults=fi)
    rids = [cl.submit(p, max_new_tokens=8) for p in prompts]
    got, stats = _drive(cl, rids)
    assert fi.fired["replica_kill"] == 1
    assert stats["failovers"] == 1 and stats["alive"] == 1
    assert _tokens(got) == ref
    assert all(reason == "length" for _, reason in got.values())


def test_block_migration_resumes_without_recompute():
    """When the survivor has free slots, a killed replica's running
    requests migrate their KV blocks and resume pure decode: the survivor
    sees ZERO prefill tokens and identical output."""
    m, _ = _model()
    prompts = _prompts(m.cfg.vocab_size, n=2, base=12)
    ref = _reference(prompts, gen=10)
    engines = [_engine(), _engine()]
    fi = FaultInjector([Fault("replica_kill", step=6, rid=0)])
    cl = Cluster(engines, faults=fi)
    # both requests on replica 0 so the survivor stays empty
    rids = [engines[0].add_request(p, max_new_tokens=10) for p in prompts]
    got, stats = _drive(cl, rids)
    assert _tokens(got) == ref
    assert stats["migrated_blocks"] > 0
    assert engines[1]._c["prefill_tokens"].value == 0, \
        "migrated requests re-prefilled (recompute instead of hand-off)"
    assert engines[1]._c["decode_tokens"].value > 0


def test_heartbeat_stall_declares_dead_and_fails_over():
    """A replica that stops stepping (without raising) while holding work
    is declared dead by the step-heartbeat and failed over."""
    m, _ = _model()
    prompts = _prompts(m.cfg.vocab_size, n=4)
    ref = _reference(prompts)
    fi = FaultInjector([Fault("heartbeat_stall", step=3, rid=0,
                              hold_steps=1000)])
    cl = Cluster([_engine(), _engine()], ClusterConfig(heartbeat_timeout=4),
                 faults=fi)
    rids = [cl.submit(p, max_new_tokens=8) for p in prompts]
    got, stats = _drive(cl, rids)
    assert fi.fired["heartbeat_stall"] == 1
    assert cl.replicas[0].state == "dead"
    assert stats["failovers"] == 1
    assert _tokens(got) == ref


def test_stall_shorter_than_timeout_recovers():
    """A transient stall inside the heartbeat window is NOT a failure: the
    replica resumes stepping and nothing fails over."""
    m, _ = _model()
    prompts = _prompts(m.cfg.vocab_size, n=4)
    ref = _reference(prompts)
    fi = FaultInjector([Fault("heartbeat_stall", step=2, rid=0,
                              hold_steps=3)])
    cl = Cluster([_engine(), _engine()], ClusterConfig(heartbeat_timeout=8),
                 faults=fi)
    rids = [cl.submit(p, max_new_tokens=8) for p in prompts]
    got, stats = _drive(cl, rids)
    assert fi.fired["heartbeat_stall"] == 1
    assert stats["failovers"] == 0 and stats["alive"] == 2
    assert _tokens(got) == ref


def test_fatal_step_error_kills_replica():
    """An AuditViolation escaping a replica's step (untrusted memory) kills
    that replica; its requests finish elsewhere identically."""
    m, _ = _model()
    prompts = _prompts(m.cfg.vocab_size, n=4)
    ref = _reference(prompts)
    engines = [_engine(), _engine()]
    cl = Cluster(engines)
    rids = [cl.submit(p, max_new_tokens=8) for p in prompts]
    for _ in range(3):
        cl.step()
    real_step = engines[0].step

    def poisoned_step():
        engines[0].step = real_step     # fire once
        raise AuditViolation("injected: cache state untrusted")

    engines[0].step = poisoned_step
    got, stats = _drive(cl, rids)
    assert cl.replicas[0].state == "dead"
    assert stats["failovers"] == 1
    assert _tokens(got) == ref


# ---------------------------------------------------------------------------
# Rolling restart
# ---------------------------------------------------------------------------

def test_rolling_restart_zero_failed_requests():
    """Restart each replica in turn mid-serve: drain (bounded), re-home the
    backlog, snapshot/restore round-trip — zero failed requests and
    identical outputs."""
    m, _ = _model()
    prompts = _prompts(m.cfg.vocab_size)
    ref = _reference(prompts)
    cl = Cluster([_engine(), _engine()], ClusterConfig(drain_timeout_s=30.0))
    rids = [cl.submit(p, max_new_tokens=8) for p in prompts]
    for _ in range(3):
        cl.step()
    cl.rolling_restart()
    assert all(r.state == "alive" for r in cl.replicas)
    got, stats = _drive(cl, rids)
    assert stats["failovers"] == 0
    assert _tokens(got) == ref
    assert all(reason in ("length", "stop") for _, reason in got.values())


def test_restart_single_replica_keeps_backlog():
    """Restarting the only replica has no survivors to migrate to: the
    backlog rides the snapshot/restore round-trip instead."""
    m, _ = _model()
    prompts = _prompts(m.cfg.vocab_size, n=5)
    ref = _reference(prompts)
    cl = Cluster([_engine()])
    rids = [cl.submit(p, max_new_tokens=8) for p in prompts]
    cl.step()
    cl.restart(0)
    assert cl.replicas[0].state == "alive"
    got, _ = _drive(cl, rids)
    assert _tokens(got) == ref


# ---------------------------------------------------------------------------
# Retry budgets and incompatible survivors
# ---------------------------------------------------------------------------

def test_retry_budget_exhausted_fails_cleanly():
    """With a zero retry budget, failover cannot re-home: the dead
    replica's requests fail with finish_reason "error" instead of crashing
    the cluster, and the survivor still serves its own."""
    m, _ = _model()
    prompts = _prompts(m.cfg.vocab_size, n=4)
    fi = FaultInjector([Fault("replica_kill", step=3, rid=0)])
    cl = Cluster([_engine(), _engine()], ClusterConfig(retry_budget=0),
                 faults=fi)
    rids = [cl.submit(p, max_new_tokens=8) for p in prompts]
    got, stats = _drive(cl, rids)
    assert stats["failovers"] == 1
    reasons = {reason for _, reason in got.values()}
    assert "error" in reasons, "budget-exhausted requests must fail"
    assert "length" in reasons, "survivor's own requests must finish"
    assert len(got) == len(prompts), "every request must get a result"


def test_mixed_tier_cluster_rehomes_same_model_only():
    """Dense and pruned tiers are both valid members, but failover only
    re-homes onto same-model survivors (identical weights): with only a
    pruned survivor, dense requests fail cleanly rather than silently
    change models."""
    m, _ = _model()
    prompts = _prompts(m.cfg.vocab_size, n=2)
    engines = [_engine(), _engine(pruned_ratio=0.5)]
    assert engines[1].model.cfg.name != m.cfg.name
    fi = FaultInjector([Fault("replica_kill", step=3, rid=0)])
    cl = Cluster(engines, faults=fi)
    rids = [engines[0].add_request(p, max_new_tokens=8) for p in prompts]
    got, stats = _drive(cl, rids)
    assert stats["failovers"] == 1
    assert all(reason == "error" for _, reason in got.values())


# ---------------------------------------------------------------------------
# Hand-off primitives: engine-level export/adopt, partial bundle
# ---------------------------------------------------------------------------

def test_export_adopt_roundtrip_partial_bundle():
    """capture_requests / adopt_requests: a mid-run engine's live requests
    move to a fresh engine through the serializable bundle (host bytes)
    and finish identically, without recompute for the running ones."""
    m, _ = _model()
    prompts = _prompts(m.cfg.vocab_size, n=4)
    ref = _reference(prompts)
    e1 = _engine()
    for p in prompts:
        e1.add_request(p, max_new_tokens=8)
    for _ in range(4):
        e1.step()
    done = {r: (tuple(rec.tokens), rec.finish_reason)
            for r, rec in e1.pop_finished().items()}
    bundle = capture_requests(e1)
    assert bundle["header"]["format"] == "repro-serve-handoff"
    carried = [r for r in bundle["requests"] if r["pools"] is not None]
    assert carried, "running requests should carry pool bytes"
    assert all(isinstance(raw, np.ndarray) for r in carried
               for _, _, raw in r["pools"].values())
    e2 = _engine()
    new_rids = adopt_requests(e2, bundle)
    assert e2._c["migrated_blocks"].value == sum(
        next(iter(r["pools"].values()))[1][1] for r in carried)
    order = [r["state"].req.rid for r in bundle["requests"]]
    out, _ = e2.run()
    assert e2._c["prefill_tokens"].value == sum(
        len(r["state"].seq) - 1 for r in bundle["requests"]
        if r["pools"] is None)
    got = dict(done)
    for old, new in zip(order, new_rids):
        got[old] = (tuple(out[new].tokens), out[new].finish_reason)
    assert _tokens(got) == ref
    # a bundle whose bytes do not fit the engine's pools is refused whole
    bad = dict(bundle, requests=[dict(r) for r in bundle["requests"]])
    r0 = next(r for r in bad["requests"] if r["pools"] is not None)
    r0["pools"] = {k: ("int8",) + v[1:] for k, v in r0["pools"].items()}
    e3 = _engine()
    with pytest.raises(ValueError, match="block bytes"):
        adopt_requests(e3, bad)
    assert not e3.scheduler.has_work


def test_adopt_rejects_oversized_request():
    """A hand-off that cannot fit the adopter at all raises ValueError (the
    cluster then fails it instead of wedging)."""
    e1 = _engine(max_len=96, num_blocks=96)
    e1.add_request(list(range(4)), max_new_tokens=60)
    h = e1.export_request(e1.scheduler.waiting[0].req.rid)
    e2 = _engine()                      # max_len 48 < 64 needed
    with pytest.raises(ValueError, match="capacity"):
        e2.adopt(h)


# ---------------------------------------------------------------------------
# kv_cache migration primitive
# ---------------------------------------------------------------------------

def test_import_slot_atomic_and_reregisters_prefix():
    """import_slot allocates atomically (headroom included), rebinds the
    table, and re-registers the chain — and a too-large import raises with
    NOTHING mutated."""
    src = PagedCache(max_seqs=2, num_blocks=16, block_size=4,
                     max_blocks_per_seq=4, prefix_caching=True)
    toks = tuple(range(8))              # two full blocks
    src.ensure(0, 8)
    src.commit(0, toks)
    blocks, chain = src.export_slot(0, 8)
    assert len(blocks) == 2 and len(chain) == 2

    dst = PagedCache(max_seqs=2, num_blocks=16, block_size=4,
                     max_blocks_per_seq=4, prefix_caching=True)
    new = dst.import_slot(1, len(blocks), chain, n_tokens=9)
    assert len(new) == 2
    assert len(dst._owned[1]) == 3      # +1 headroom block for token 9
    assert dst._chain[1] == chain
    for h, b in zip(chain, new):
        assert dst._block_of[h] == b and dst._hash_of[b] == h
    dst.check()
    dst.ensure(1, 9)                    # headroom means no extra alloc
    assert len(dst._owned[1]) == 3
    dst.release(1)
    dst.check()

    # atomicity: an import that cannot fit leaves the cache untouched
    tiny = PagedCache(max_seqs=2, num_blocks=4, block_size=4,
                      max_blocks_per_seq=4, prefix_caching=True)
    tiny.ensure(0, 8)                   # 2 of 3 usable blocks taken
    with pytest.raises(OutOfBlocks):
        tiny.import_slot(1, 2, chain, n_tokens=9)
    assert tiny._owned[1] == [] and not tiny._chain[1]
    tiny.check()


def test_cross_replica_prefix_alias_after_migration():
    """Re-registered chains make cross-replica prefix aliases legal: a NEW
    request sharing the migrated request's prompt prefix hits the
    survivor's prefix cache."""
    m, _ = _model()
    prompt = _prompts(m.cfg.vocab_size, n=1, base=12, seed=5)[0]
    engines = [_engine(), _engine()]
    fi = FaultInjector([Fault("replica_kill", step=6, rid=0)])
    cl = Cluster(engines, faults=fi)
    rids = [engines[0].add_request(prompt, max_new_tokens=10)]
    _, stats = _drive(cl, rids)
    assert stats["migrated_blocks"] > 0
    surv = engines[1]
    hits0 = surv.cache_host.prefix_hits
    surv.add_request(prompt, max_new_tokens=4)
    surv.run()
    assert surv.cache_host.prefix_hits > hits0, \
        "migrated chain did not serve a prefix hit"
    surv.cache_host.check()


# ---------------------------------------------------------------------------
# Bounded drain
# ---------------------------------------------------------------------------

def test_drain_deadline_force_preempts_to_waiting():
    """drain(timeout) past its deadline (on the patched clock)
    force-preempts stragglers back to the waiting queue with generated
    tokens preserved; a snapshot round-trip then resumes them
    identically."""
    m, _ = _model()
    prompts = _prompts(m.cfg.vocab_size, n=3)
    ref = _reference(prompts, gen=16)
    eng = _engine(drain_timeout_s=1e-6)
    for p in prompts:
        eng.add_request(p, max_new_tokens=16)
    for _ in range(4):
        eng.step()
    drained = eng.drain()               # deadline already expired
    assert not eng.scheduler.running, "stragglers must be preempted"
    preempted = list(eng.scheduler.waiting)
    assert preempted, "expected force-preempted requests"
    assert any(s.generated for s in preempted), \
        "preempted requests must keep generated tokens"
    a = eng.cache_host.allocator
    assert a.num_live == 0 and a.num_held == 0
    eng.cache_host.check()
    eng2 = _engine(drain_timeout_s=1e-6)
    restore_into(eng2, eng.snapshot())
    out, _ = eng2.run()
    got = {r: tuple(rec.tokens) for r, rec in drained.items()}
    got.update({r: tuple(rec.tokens) for r, rec in out.items()})
    assert got == ref


def test_drain_unbounded_still_completes():
    """timeout 0 keeps the unbounded drain."""
    m, _ = _model()
    prompts = _prompts(m.cfg.vocab_size, n=3)
    ref = _reference(prompts)
    eng = _engine()
    for p in prompts:
        eng.add_request(p, max_new_tokens=8)
    eng.step()
    drained = eng.drain(timeout_s=0)
    assert not eng.scheduler.running
    got = {r: tuple(rec.tokens) for r, rec in drained.items()}
    assert got and all(got[r] == ref[r] for r in got)


# ---------------------------------------------------------------------------
# Routing
# ---------------------------------------------------------------------------

def test_submit_falls_through_backpressure():
    """A replica refusing admission (max_waiting) is skipped; the request
    lands on the next candidate instead of erroring."""
    m, _ = _model()
    engines = [_engine(max_waiting=1), _engine(max_waiting=1)]
    cl = Cluster(engines)
    prompts = _prompts(m.cfg.vocab_size, n=2)
    r0 = cl.submit(prompts[0], max_new_tokens=4)
    r1 = cl.submit(prompts[1], max_new_tokens=4)
    # one on each replica despite both queues capping at 1
    assert len(engines[0].scheduler.waiting) == 1
    assert len(engines[1].scheduler.waiting) == 1
    got, _ = _drive(cl, [r0, r1])
    assert len(got) == 2


# ---------------------------------------------------------------------------
# The port's in-flight step: discard_inflight on an async engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("after", ["continue", "migrate"])
def test_discard_inflight_async(after):
    """An async engine with a step in flight (overlapped, its tokens fed
    on the device) discards it: the record's buffer is never read, no
    later step feeds from its device tensors, every cursor rolls back to
    known tokens — and serving on (``continue``), or exporting every live
    request to a second engine (``migrate``), gives the lockstep run's
    tokens."""
    m, _ = _model()
    prompts = _prompts(m.cfg.vocab_size, n=5)
    ref = _reference(prompts, gen=10)
    e1 = _engine(async_step=True)
    for p in prompts:
        e1.add_request(p, max_new_tokens=10)
    for _ in range(6):
        e1.step_async()
    rec = e1._pending
    assert rec is not None and rec.src, "no token in flight to discard"
    live = list(e1.scheduler.running) + list(e1.scheduler.waiting)
    dropped = {id(t) for t in rec.fetch.values()}
    real_fetch = e1._fetch

    def fetch(r):
        assert r is not rec, "the discarded step's fetch was read"
        return real_fetch(r)

    e1._fetch = fetch
    e1.discard_inflight()
    assert e1._pending is None
    assert all(s.pending == 0 and s.num_cached <= len(s.seq) - 1
               for s in live)
    real_where = torch.where

    def where(*args, **kw):
        assert not dropped & {id(a) for a in args}, \
            "a later step fed a dropped token"
        return real_where(*args, **kw)

    done = {r: tuple(x.tokens) for r, x in e1.pop_finished().items()}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(engine_mod.torch, "where", where)
        if after == "continue":
            while e1.scheduler.has_work or e1.pending_step:
                e1.step_async()
            done.update({r: tuple(x.tokens)
                         for r, x in e1.pop_finished().items()})
        else:
            e2 = _engine(async_step=True)
            e2._rid = 100
            moved = {}
            for rid in [s.req.rid for s in e1.scheduler.running
                        if not s.done]:
                moved[e2.adopt(e1.export_request(rid, remove=True))] = rid
            for h in e1.export_backlog(remove=True):
                moved[e2.adopt(h)] = h.state.req.rid
            e1.scheduler.retire_finished()
            done.update({r: tuple(x.tokens)
                         for r, x in e1.pop_finished().items()})
            assert e2._c["migrated_blocks"].value > 0
            while e2.scheduler.has_work or e2.pending_step:
                e2.step_async()
            done.update({moved[r]: tuple(x.tokens)
                         for r, x in e2.pop_finished().items()})
            assert e2.cache_host.allocator.num_live == 0
    assert done == ref
    assert e1.cache_host.allocator.num_live == 0
    e1.cache_host.check()


# ---------------------------------------------------------------------------
# Across frameworks: the port's cluster and migration loop against JAX's
# ---------------------------------------------------------------------------

_JCFG = dict(max_seqs=3, block_size=4, num_blocks=24, max_len=48,
             chunk_size=8, audit_level="full")


def _jax_pair():
    """Two JAX engines and two port engines (``_JCFG``) on reduced
    TinyLlama from PRNGKey(0), the port's weights converted; built once
    (each JAX engine compiles its own steps) and reset by every user."""
    if "jax" not in _MODELS:
        jm = j_build(j_reduced(j_get_config("tinyllama-1.1b")))
        jp = jm.init(jax.random.PRNGKey(0))
        tm = build(convert.convert_config(dataclasses.asdict(jm.cfg)))
        tp = convert.convert_params(jax.tree.map(np.asarray, jp))
        je = [JEngine(jm, jp, JServeConfig(**_JCFG)) for _ in range(2)]
        te = [Engine(tm, tp, ServeConfig(**_JCFG), device="cpu")
              for _ in range(2)]
        _MODELS["jax"] = (jm, jp, je, te)
    jm, jp, je, te = _MODELS["jax"]
    for e in je + te:
        e.reset()
        e.faults = None
    return jm, jp, je, te


def _hold_tokens(jm, jp, prompts, jtoks, ttoks):
    """The port's tokens against the reference's: equal where the
    reference's top-2 logit gap clears MARGIN at every position of its own
    sequence; otherwise each port token within 1e-4 of the reference's
    teacher-forced maximum over the port's sequence."""
    def logits(seqs):
        batch = np.zeros((len(seqs), max(map(len, seqs))), np.int32)
        for i, q in enumerate(seqs):
            batch[i, :len(q)] = q
        return np.asarray(jm.forward(jp, {"tokens": jnp.asarray(batch)}))

    keys = sorted(jtoks)
    lg = logits([list(prompts[k]) + list(jtoks[k]) for k in keys])
    forced = []
    for i, k in enumerate(keys):
        n, p = len(jtoks[k]), len(prompts[k])
        top = np.sort(lg[i, p - 1:p - 1 + n], axis=-1)
        if (top[:, -1] - top[:, -2]).min() > MARGIN:
            assert tuple(ttoks[k]) == tuple(jtoks[k]), k
        else:
            forced.append(k)
    if forced:
        lt = logits([list(prompts[k]) + list(ttoks[k]) for k in forced])
        for i, k in enumerate(forced):
            n, p = len(ttoks[k]), len(prompts[k])
            at = lt[i, p - 1:p - 1 + n]
            short = at.max(axis=1) - at[np.arange(n), list(ttoks[k])]
            assert short.max() <= 1e-4, (k, short.max())


def _record_exports(engines, log):
    """Log every hand-off the engines export: (rid, chain, num_cached,
    pool bytes as f32 numpy)."""
    for e in engines:
        inner = e.export_request

        def export(rid, remove=False, _inner=inner):
            h = _inner(rid, remove=remove)
            pools = None if h.pools is None else {
                k: v.float().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v, np.float32) for k, v in h.pools.items()}
            log.append((rid, list(h.chain), h.num_cached, pools))
            return h
        e.export_request = export


def test_cluster_failover_vs_jax_cluster():
    """Same converted weights, requests and ``replica_kill`` tick on the
    reference's Cluster and the port's: identical routing per rid, alive
    sets, failovers, migrated blocks, finish reasons and hand-off chains /
    cursors; the gathered pool bytes within 1e-5; tokens by the gap rule.
    Replica 0 dies mid-decode holding two running requests; the survivor
    has one free slot, so one migrates its blocks and one re-prefills."""
    jm, jp, je, te = _jax_pair()
    rng = np.random.default_rng(43)
    prompts = [[int(t) for t in rng.integers(0, jm.cfg.vocab_size, n)]
               for n in (10, 9, 8, 10)]
    gen = 8

    def serve(cluster_cls, fault, injector, engines):
        log: list = []
        _record_exports(engines, log)
        cl = cluster_cls(engines, faults=injector(
            [fault("replica_kill", step=6, rid=0)]))
        rids = [cl.submit(p, max_new_tokens=gen) for p in prompts]
        res, stats = cl.run(max_ticks=500)
        for e in engines:
            del e.export_request
        assert not cl.has_work
        cl.check()
        alive = [r.state for r in cl.replicas]
        return rids, res, stats, alive, log

    jr, jres, jst, jalive, jlog = serve(JCluster, JFault, JFaultInjector, je)
    tr, tres, tst, talive, tlog = serve(Cluster, Fault, FaultInjector, te)
    stride = ClusterConfig().rid_stride
    assert [r // stride for r in tr] == [r // stride for r in jr] == \
        [0, 1, 0, 1]
    assert tr == jr and talive == jalive == ["dead", "alive"]
    for k in ("failovers", "migrated_blocks", "ticks", "steps", "completed"):
        assert tst[k] == jst[k], k
    assert tst["failovers"] == 1 and tst["migrated_blocks"] > 0
    assert {r: x.finish_reason for r, x in tres.items()} == \
        {r: x.finish_reason for r, x in jres.items()}
    assert len(tlog) == len(jlog) >= 2
    for (a, ca, na, pa), (b, cb, nb, pb) in zip(tlog, jlog):
        assert (a, ca, na) == (b, cb, nb)
        assert (pa is None) == (pb is None)
        if pa is not None:
            assert set(pa) == set(pb)
            for k in pa:
                assert pa[k].shape == pb[k].shape
                np.testing.assert_allclose(pa[k], pb[k], rtol=0, atol=1e-5)
    assert any(p is not None for *_, p in tlog)
    idx = {r: i for i, r in enumerate(tr)}
    _hold_tokens(jm, jp, {idx[r]: prompts[idx[r]] for r in tr},
                 {idx[r]: jres[r].tokens for r in jr},
                 {idx[r]: tres[r].tokens for r in tr})


def _drive_migration(e1, e2, prompts, migrate_at, faults1=None,
                     faults2=None, gen=6):
    """The reference's two-engine migration loop
    (``tests/test_serve_properties.py::_drive_migration``) on either
    framework's engines: decode-phase requests migrate e1 -> e2 at the
    given rounds, every allocator balances every round, and every request
    finishes on exactly one engine.  It records each round's allocator
    counts (free, live, cached, held of both engines) instead of asserting
    zero held at the end.  Returns ({submission index: (tokens, reason)},
    migrated, rounds)."""
    e1.reset()
    e2.reset()
    e2._rid = 1 << 20              # disjoint rid namespaces (cluster-style)
    e1.faults, e2.faults = faults1, faults2
    idx = {}
    for i, p in enumerate(prompts):
        idx[e1.add_request(p, max_new_tokens=gen)] = i
    totals = {id(e): e.cache_host.allocator.num_free for e in (e1, e2)}
    migrate_at = set(migrate_at)
    migrated, rounds, n = 0, [], 0
    while any(e.scheduler.has_work or e.pending_step for e in (e1, e2)):
        if n in migrate_at:
            for s in list(e1.scheduler.running):
                if s.phase == "decode" and not s.done:
                    rid = s.req.rid
                    h = e1.export_request(rid, remove=True)
                    idx[e2.adopt(h)] = idx.pop(rid)
                    migrated += 1
        for e in (e1, e2):
            if e.scheduler.has_work or e.pending_step:
                e.step()
        row = []
        for e in (e1, e2):
            e.cache_host.check()
            a = e.cache_host.allocator
            assert a.num_free + a.num_live + a.num_cached \
                + a.num_held == totals[id(e)], "cross-engine conservation"
            row.append((a.num_free, a.num_live, a.num_cached, a.num_held))
        rounds.append(row)
        n += 1
        assert n <= 500, "no progress under migration schedule"
    e1.faults = e2.faults = None
    out = {}
    for e in (e1, e2):
        assert e.cache_host.allocator.num_live == 0
        for rid, rec in e.pop_finished().items():
            i = idx.pop(rid)
            assert i not in out, "request finished on both engines"
            out[i] = (tuple(rec.tokens), rec.finish_reason)
    assert not idx, "requests lost in migration"
    return out, migrated, rounds


@pytest.mark.parametrize("schedule", ["fixed", "held_after_drain"])
def test_migration_loop_vs_jax(schedule):
    """The reference's migration loop on both frameworks' engines, on
    converted weights.  ``fixed`` is its seeded schedule (hand-offs at
    rounds 2, 4, 7 land mid-``alloc_hold`` on the adopter and bracket sync
    errors); ``held_after_drain`` is the case of the reference's known
    flake (4 prompts of 8-10 tokens, a migration at round 8, ``alloc_hold``
    at step 5 for 3 steps on the exporter): once every sequence has left
    e1, nothing steps it, so its hold is never handed back.  The port keeps
    that behaviour; the test holds the allocator counts of both engines to
    the reference's after every round, the migrations, the finish reasons,
    each framework's tokens to its own single-engine run, and the port's
    tokens to the reference's by the gap rule."""
    jm, jp, je, te = _jax_pair()
    prng = np.random.default_rng(59)
    prompts = [[int(t) for t in prng.integers(0, jm.cfg.vocab_size,
                                              10 - (i % 3))]
               for i in range(4)]
    if schedule == "fixed":
        at = (2, 4, 7)

        def faults(F, I):
            return (I([F("sync_error", step=4)], seed=0),
                    I([F("alloc_hold", step=1, blocks=12, hold_steps=3),
                       F("sync_error", step=5)], seed=1))
    else:
        at = (8,)

        def faults(F, I):
            return (I([F("alloc_hold", step=5, hold_steps=3)], seed=0),
                    I([], seed=1))

    runs = {}
    for name, (e1, e2), F, I in (("jax", je, JFault, JFaultInjector),
                                 ("port", te, Fault, FaultInjector)):
        ref, _, _ = _drive_migration(e1, e2, prompts, ())
        f1, f2 = faults(F, I)
        out, migrated, rounds = _drive_migration(e1, e2, prompts, at,
                                                 faults1=f1, faults2=f2)
        assert migrated > 0, "schedule never exercised a migration"
        assert out == ref, name
        runs[name] = (out, migrated, rounds, dict(f1.fired),
                      dict(f2.fired), e1.cache_host.allocator.num_held)
    (jout, jmig, jrounds, *jfired, jheld), (tout, tmig, trounds, *tfired,
                                           theld) = runs["jax"], runs["port"]
    assert tmig == jmig and tfired == jfired
    assert trounds == jrounds
    assert theld == jheld
    if schedule == "held_after_drain":
        assert theld > 0, "the reference's held-after-drain case is gone"
    assert {i: r for i, (_, r) in tout.items()} == \
        {i: r for i, (_, r) in jout.items()}
    _hold_tokens(jm, jp, dict(enumerate(prompts)),
                 {i: t for i, (t, _) in jout.items()},
                 {i: t for i, (t, _) in tout.items()})
