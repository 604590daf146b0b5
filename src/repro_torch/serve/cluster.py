"""Replicated fault-tolerant serving: a router over N engine replicas.

``Cluster`` fronts N :class:`~repro.serve.engine.Engine` replicas on one
host (DESIGN.md §15) — dense and pruned tiers are both valid members —
and owns the control plane the single engine deliberately does not:

  - **routing**: ``submit`` places each request on the least-loaded
    alive replica, falling through ``EngineOverloaded`` backpressure to
    the next candidate;
  - **health**: a replica is declared dead when a step raises a fatal
    error (:class:`CrashError`, :class:`AuditViolation`, an escaped
    :class:`FaultError`) or when its step-heartbeat stalls — it holds
    work but its step counter has not advanced for
    ``heartbeat_timeout`` cluster ticks;
  - **failover**: a dead replica's waiting backlog and the
    snapshot-captured state of its running requests are re-homed onto
    surviving same-model replicas via the engine handoff primitives
    (``export_request`` / ``export_backlog`` / ``adopt``).  Running
    requests carry their KV(+scale) pool bytes when the survivor is
    byte-compatible (``handoff_key``), so they resume decode without
    recompute; otherwise they re-prefill their known prefix.  Either
    way, at temperature 0 the token stream is byte-identical to a run
    that never failed over (per-request outputs are batch-independent);
  - **rolling restarts**: ``restart`` drains a replica (bounded by
    ``drain_timeout_s``), re-homes its backlog onto survivors, round-
    trips the remainder through snapshot/restore, and re-admits the
    replica — ``rolling_restart`` does each replica in turn with zero
    failed requests.

Disaggregated prefill/decode (DESIGN.md §16): each replica carries the
*role* its engine was configured with (``ServeConfig.role``).  A
``prefill`` replica plans prefill chunks only — new prompts are routed
to it, the final chunk samples the first token, and the sequence is
then *parked*; every cluster tick migrates parked sequences to the
least-loaded compatible decode-capable replica over the same
``export_slot``/``import_slot`` byte-exact block transport failover
uses (zero recompute; the adopter falls back to waiting-with-recompute
when its pool lacks headroom right now).  A ``decode`` replica is kept
off the new-prompt routing path but plans normally, so the recompute
fallback and failover re-homes still work on it.  ``mixed`` (the
default) opts out of all of this.  Planned migrations never burn the
retry budget; a dying prefill replica's half-prefilled sequences
re-home through the ordinary failover path with role-aware placement.

Request identity: each replica's ``_rid`` counter is pre-based at
``replica_index * rid_stride`` so locally-assigned rids are globally
unique — no rid translation on the hot path and no collisions in the
shared Chrome trace (request spans are keyed by rid).  A re-homed
request gets a fresh rid on its new engine; ``_alias`` maps it back to
the original, which is what ``results`` are keyed by.

Fault injection: the cluster consumes the *cluster-scoped* fault kinds
(``replica_kill``, ``heartbeat_stall``) from its own
:class:`FaultInjector`; engine-scoped kinds keep firing inside each
replica's own injector.  Observability: pass one cluster ``Telemetry``
and each replica gets a private view — its own registry (an engine's
``reset()``/restore rewrites counters and must not clobber cluster
totals) sharing the single trace buffer on a per-replica track.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Iterable

from repro_torch.obs import DEFAULT_TIME_BUCKETS, MetricsRegistry, Telemetry
from repro_torch.serve.engine import (AuditViolation, Engine, EngineOverloaded,
                                FinishedRequest, SequenceHandoff)
from repro_torch.serve.faults import CrashError, FaultError, FaultInjector

# fatal step escapes: anything an engine cannot recover in-process
FATAL = (CrashError, AuditViolation, FaultError)


@dataclasses.dataclass
class ClusterConfig:
    heartbeat_timeout: int = 8     # ticks without a beat while holding
    #                                work before a replica is declared dead
    retry_budget: int = 2          # failover re-homings per request before
    #                                it fails with finish_reason "error"
    #                                (planned drain migrations don't count)
    drain_timeout_s: float = 30.0  # rolling-restart drain deadline
    rid_stride: int = 1 << 20      # per-replica rid namespace width


@dataclasses.dataclass
class Replica:
    engine: Engine
    name: str
    role: str = "mixed"            # mirror of engine.cfg.role
    state: str = "alive"           # alive | draining | dead
    last_beat: int = 0             # cluster tick of the last heartbeat
    last_steps: int = 0            # engine step counter at that beat
    stall_until: int = 0           # injected heartbeat_stall: skip steps
    #                                until this cluster tick


class Cluster:
    def __init__(self, engines: Iterable[Engine],
                 cfg: ClusterConfig | None = None,
                 telemetry: Telemetry | None = None,
                 faults: FaultInjector | None = None):
        engines = list(engines)
        if not engines:
            raise ValueError("cluster needs at least one engine")
        self.cfg = cfg or ClusterConfig()
        self.faults = faults
        self.obs = telemetry
        # cluster-level counters live in the cluster's registry, never a
        # replica's (replica registries are rewritten by reset/restore)
        self.registry = telemetry.registry if telemetry is not None \
            else MetricsRegistry()
        self._failovers = self.registry.counter("serve/failovers")
        self._migrated = self.registry.counter("serve/migrated_blocks")
        self._disagg = self.registry.counter("serve/disagg_migrations")
        self.replicas: list[Replica] = []
        for i, eng in enumerate(engines):
            role = eng.cfg.role
            name = f"replica{i}:{eng.model.cfg.name}" + \
                ("" if role == "mixed" else f":{role}")
            if telemetry is not None:
                # private registry per replica, shared trace, own track
                # (per-role track names: the trace shows which lane is
                # prefill vs decode at a glance)
                eng.obs = Telemetry(enabled=telemetry.enabled,
                                    trace=telemetry.trace, track=i)
                telemetry.trace.set_track_name(i, name)
                eng.reset()            # re-register counters there
            # rid namespacing: engine-assigned rids are globally unique
            eng._rid = i * self.cfg.rid_stride
            self.replicas.append(Replica(engine=eng, name=name, role=role))
        if any(r.role == "prefill" for r in self.replicas) and \
                not any(r.role != "prefill" for r in self.replicas):
            raise ValueError("a cluster with prefill-role replicas needs "
                             "at least one decode-capable replica")
        self._tick = 0
        self._alias: dict[int, int] = {}      # current rid -> original rid
        self._retries: dict[int, int] = {}    # original rid -> failovers
        self._results: dict[int, FinishedRequest] = {}

    # ----- routing -----
    def _load(self, r: Replica) -> int:
        s = r.engine.scheduler
        return len(s.running) + len(s.waiting)

    def _alive(self) -> list[Replica]:
        return [r for r in self.replicas if r.state == "alive"]

    def submit(self, prompt, **kw) -> int:
        """Route one request (``Engine.add_request`` kwargs) to the
        least-loaded alive replica; backpressure falls through to the
        next candidate.  Returns the globally-unique rid.

        Role-aware: decode-role replicas are skipped while any prefill-
        capable (prefill/mixed) replica is alive — new prompts are
        prefill work.  If only decode replicas survive, they take the
        prompts anyway (their engines plan normally); availability
        beats the role split."""
        alive = sorted(self._alive(), key=self._load)
        if not alive:
            raise RuntimeError("no alive replicas")
        pref = [r for r in alive if r.role != "decode"]
        last: Exception | None = None
        for r in pref or alive:
            try:
                return r.engine.add_request(prompt, **kw)
            except EngineOverloaded as e:
                last = e
        raise last

    # ----- health + driving -----
    def step(self) -> None:
        """One cluster tick: fire cluster-scoped faults, step every alive
        replica that has work, update heartbeats, declare the dead dead
        (failing over their requests), and collect finished records."""
        self._tick += 1
        if self.faults is not None:
            for i, r in enumerate(self.replicas):
                if r.state != "alive":
                    continue
                if self.faults.fire("replica_kill", self._tick, rid=i):
                    self.kill(i, reason="replica_kill")
                    continue
                f = self.faults.fire("heartbeat_stall", self._tick, rid=i)
                if f is not None:
                    r.stall_until = self._tick + f.hold_steps
        for i, r in enumerate(self.replicas):
            if r.state != "alive":
                continue
            eng = r.engine
            busy = eng.scheduler.has_work or eng.pending_step
            if busy and self._tick >= r.stall_until:
                step = eng.step_async if eng.cfg.async_step else eng.step
                try:
                    step()
                except FATAL as e:
                    self.kill(i, reason=type(e).__name__)
                    continue
            steps = eng._steps
            if not busy or steps != r.last_steps:
                r.last_beat, r.last_steps = self._tick, steps
            elif self._tick - r.last_beat > self.cfg.heartbeat_timeout:
                self.kill(i, reason="heartbeat")
                continue
            self._collect(i)
        self._migrate_ready()
        if self.obs is not None and self.obs.enabled:
            for i, r in enumerate(self.replicas):
                a = r.engine.cache_host.allocator
                self.obs.sample(f"replica/{i}", {
                    "alive": 1.0 if r.state == "alive" else 0.0,
                    "running": float(len(r.engine.scheduler.running)),
                    "waiting": float(len(r.engine.scheduler.waiting)),
                    "free_blocks": float(a.num_free)})

    def _collect(self, i: int) -> None:
        # a finished request retires its routing state with it: the
        # alias entry that mapped its migrated rid home and whatever
        # retry budget it burned — long-lived clusters must not grow
        # either map without bound
        for rid, rec in self.replicas[i].engine.pop_finished().items():
            orig = self._alias.pop(rid, rid)
            self._retries.pop(orig, None)
            self._results[orig] = dataclasses.replace(rec, rid=orig)

    # ----- prefill/decode disaggregation (DESIGN.md §16) -----
    def _migrate_ready(self) -> None:
        """Move every parked sequence off the prefill replicas: a
        prefill-role engine plans no decode work, so a request whose
        final chunk completed (``decode_ready``) sits until this hands
        its KV+scale blocks and prefix chain to the least-loaded
        compatible decode-capable replica.  Pool headroom is not
        required — ``adopt`` falls back to waiting-with-recompute on
        the target — but a request no decode-capable replica can ever
        fit fails here, exactly like failover with no survivor.
        Planned migrations never burn the retry budget."""
        for r in self.replicas:
            if r.state != "alive" or r.role != "prefill":
                continue
            eng = r.engine
            for rid in eng.decode_ready():
                t0 = time.perf_counter()
                h = eng.export_request(rid, remove=True)
                orig = self._alias.pop(rid, rid)
                targets = sorted(
                    (t for t in self._compatible(h) if t.role != "prefill"),
                    key=lambda t: (t.role != "decode", self._load(t)))
                if self._adopt_onto(h, orig, targets):
                    self._disagg.inc()
                    # migrating work off a replica is scheduling
                    # progress; don't let the heartbeat starve a
                    # prefill replica that just went idle this way
                    r.last_beat = self._tick
                    if self.obs is not None:
                        self.obs.observe("migrate/handoff_s",
                                         time.perf_counter() - t0,
                                         buckets=DEFAULT_TIME_BUCKETS)
                else:
                    self._fail(orig, h)

    # ----- failover -----
    def kill(self, i: int, reason: str = "killed") -> None:
        """Declare replica ``i`` dead and fail over: salvage finished
        records, then re-home its running requests (with their snapshot-
        captured KV state) and waiting backlog onto survivors."""
        r = self.replicas[i]
        if r.state == "dead":
            return
        r.state = "dead"
        self._failovers.inc()
        eng = r.engine
        eng.discard_inflight()          # in-flight samples are lost
        eng.scheduler.retire_finished()
        self._collect(i)
        rids = [s.req.rid for s in eng.scheduler.running if not s.done]
        handoffs = [eng.export_request(rid) for rid in rids]
        handoffs += eng.export_backlog()
        self._rehome(handoffs, count_retry=True)

    def _compatible(self, h: SequenceHandoff) -> list[Replica]:
        """Alive replicas a handoff can land on at all (byte parity
        holds only across identical model + params)."""
        return [t for t in self._alive()
                if t.engine.model.cfg.name == h.key[0]
                and t.engine.model.cfg.vocab_size == h.key[1]]

    def _adopt_onto(self, h: SequenceHandoff, orig: int,
                    targets: list[Replica]) -> bool:
        """Adopt a handoff onto the first target that fits; rewires the
        rid alias and counts migrated blocks.  False = none fit."""
        for t in targets:
            try:
                before = t.engine._c["migrated_blocks"].value
                new_rid = t.engine.adopt(h)
            except ValueError:
                continue                # does not fit this replica
            self._alias[new_rid] = orig
            self._migrated.inc(
                t.engine._c["migrated_blocks"].value - before)
            return True
        return False

    def _rehome(self, handoffs: list[SequenceHandoff],
                count_retry: bool) -> None:
        """Adopt each handoff onto the least-loaded alive replica running
        the same model.  ``count_retry`` failovers burn the request's
        retry budget; planned drain migrations do not.  A request with no
        compatible survivor, an exhausted budget, or no room anywhere
        fails with finish_reason "error".

        Role-aware placement: a handoff still in its prefill phase needs
        prefill steps, so prefill-capable (prefill/mixed) replicas are
        preferred but any compatible replica works (decode-role engines
        plan normally).  A decode-phase handoff parked on a prefill-role
        replica would never advance, so those are restricted to decode-
        capable replicas outright."""
        for h in handoffs:
            old = h.state.req.rid
            orig = self._alias.pop(old, old)
            if count_retry:
                self._retries[orig] = self._retries.get(orig, 0) + 1
                if self._retries[orig] > self.cfg.retry_budget:
                    self._fail(orig, h)
                    continue
            decode_phase = h.state.phase == "decode"
            if decode_phase:
                targets = sorted(
                    (t for t in self._compatible(h)
                     if t.role != "prefill"),
                    key=lambda t: (t.role != "decode", self._load(t)))
            else:
                targets = sorted(
                    self._compatible(h),
                    key=lambda t: (t.role == "decode", self._load(t)))
            if not self._adopt_onto(h, orig, targets):
                self._fail(orig, h)

    def _fail(self, orig: int, h: SequenceHandoff) -> None:
        self._retries.pop(orig, None)   # terminal: retire its budget
        st = h.state
        self._results[orig] = FinishedRequest(
            rid=orig, prompt=st.req.prompt, tokens=list(st.generated),
            preemptions=getattr(st, "preemptions", 0), steps=0,
            finish_reason="error")
        if h.on_token is not None:      # tokenless terminal callback
            try:
                h.on_token(None, True)
            except Exception:
                pass

    # ----- rolling restart -----
    def restart(self, i: int) -> None:
        """Rolling-restart replica ``i``: drain (deadline-bounded), hand
        its backlog to survivors, round-trip the remainder through
        snapshot/restore, and re-admit it.  Nothing fails: requests
        either finish during the drain, migrate, or ride the snapshot."""
        r = self.replicas[i]
        assert r.state == "alive", f"restart of {r.state} replica {i}"
        r.state = "draining"
        eng = r.engine
        if r.role == "prefill":
            # a prefill replica cannot finish its running requests —
            # they park at decode phase — so a deadline-bounded drain
            # would only burn the deadline.  Migrate everything live
            # instead (reconciled export, nothing lost, no retry cost).
            rids = [s.req.rid for s in eng.scheduler.running if not s.done]
            handoffs = [eng.export_request(rid, remove=True)
                        for rid in rids]
            handoffs += eng.export_backlog(remove=True)
            self._rehome(handoffs, count_retry=False)
            self._collect(i)
        else:
            for rid, rec in eng.drain(self.cfg.drain_timeout_s).items():
                orig = self._alias.pop(rid, rid)
                self._retries.pop(orig, None)
                self._results[orig] = dataclasses.replace(rec, rid=orig)
            others = [t for t in self._alive() if t is not r]
            if others:
                self._rehome(eng.export_backlog(remove=True),
                             count_retry=False)
        snap = eng.snapshot()
        eng.restore(snap)               # reset + byte-identical resume;
        r.state = "alive"               # restore clears the drain latch
        r.last_beat, r.last_steps = self._tick, eng._steps

    def rolling_restart(self) -> None:
        for i, r in enumerate(self.replicas):
            if r.state == "alive":
                self.restart(i)

    def drain_all(self, timeout_s: float | None = None
                  ) -> dict[int, FinishedRequest]:
        """Gracefully drain every alive replica (the signal-driven
        shutdown path); returns the newly drained records keyed by
        original rid.  Replicas are left draining — this is shutdown,
        not a restart."""
        if timeout_s is None:
            timeout_s = self.cfg.drain_timeout_s
        out: dict[int, FinishedRequest] = {}
        for r in self._alive():
            for rid, rec in r.engine.drain(timeout_s).items():
                orig = self._alias.pop(rid, rid)
                self._retries.pop(orig, None)
                rec = dataclasses.replace(rec, rid=orig)
                self._results[orig] = rec
                out[orig] = rec
        return out

    # ----- drive to completion -----
    @property
    def has_work(self) -> bool:
        return any(r.engine.scheduler.has_work or r.engine.pending_step
                   for r in self._alive())

    def run(self, requests: Iterable[dict[str, Any]] | None = None,
            stop_when=None, max_ticks: int = 0
            ) -> tuple[dict[int, FinishedRequest], dict[str, float]]:
        """Drive until every alive replica drains (or none remain).
        Returns ({original rid: record}, stats).  ``max_ticks`` bounds
        the drive (0 = unbounded) — chaos tests use it as a deadlock
        guard."""
        if requests:
            for req in requests:
                self.submit(**req)
        t0 = time.time()
        n0 = self._tick
        while self._alive() and self.has_work:
            if stop_when is not None and stop_when():
                break
            if max_ticks and self._tick - n0 >= max_ticks:
                break
            self.step()
        return dict(self._results), self.stats(time.time() - t0)

    def stats(self, wall_s: float = 0.0) -> dict[str, float]:
        alive = self._alive()
        return {
            "wall_s": wall_s,
            "ticks": float(self._tick),
            "replicas": float(len(self.replicas)),
            "alive": float(len(alive)),
            "failovers": float(self._failovers.value),
            "migrated_blocks": float(self._migrated.value),
            "disagg_migrations": float(self._disagg.value),
            "steps": float(sum(r.engine._steps for r in self.replicas)),
            "completed": float(len(self._results)),
        }

    def check(self) -> None:
        """Audit every alive replica's cache invariants."""
        for r in self._alive():
            r.engine.cache_host.check()
