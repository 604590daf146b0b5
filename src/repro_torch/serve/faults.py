"""Deterministic, seeded fault injection for the serving engine.

The chaos suite (tests/test_serve_chaos.py) needs to drive the engine
through production failure modes — allocator exhaustion, device-sync
errors, slow steps, user-callback exceptions, a host crash at step K —
and then assert byte-identical outputs for every request a fault did
not touch.  That only works if the fault schedule itself is exactly
reproducible, so everything here is host-side and deterministic:

  - A schedule is a list of frozen :class:`Fault` specs.  A spec either
    pins a step (``step=K``: fires when the engine's step counter hits
    K) or draws per-opportunity from one ``random.Random(seed)``
    (``rate=p``).  Each spec fires at most ``times`` times.
  - The engine owns the hook points and consults the injector at fixed
    seams (start of step, inside ``_fetch``, inside the ``on_token``
    emit path).  The PRNG is consumed only when a live rate-spec is
    eligible at that seam, so the draw sequence — and therefore the
    whole schedule — is a pure function of ``(faults, seed)`` and the
    engine's own deterministic step sequence.
  - ``Engine(..., faults=None)`` keeps the entire layer out of the hot
    path: every hook is behind a single ``is None`` check.

Fault kinds (see DESIGN.md §14 for how the engine recovers from each):

  - ``alloc_hold``: sequester ``blocks`` free blocks for ``hold_steps``
    steps via the allocator's first-class *held* state, simulating pool
    exhaustion honestly (conservation invariants still audit clean).
  - ``sync_error``: raise :class:`FaultError` from the engine's host
    sync (``jax.device_get``) — a transient device/transfer failure.
  - ``slow_step``: sleep ``delay_s`` at the top of a step, simulating a
    straggler step for deadline/shedding tests.
  - ``callback_error``: raise from inside the user's ``on_token``
    callback for request ``rid`` (or whichever request emits first).
  - ``crash``: raise :class:`CrashError` at the very start of step K —
    the simulated hard host crash that snapshot/restore tests recover
    from.

Cluster-scoped kinds (consumed by ``repro.serve.cluster``, not the
engine; ``rid`` selects the *replica* index instead of a request):

  - ``replica_kill``: the cluster kills replica ``rid`` at cluster tick
    ``step`` — the crash-at-step-K fault at the replica granularity.
    Failover re-homes its backlog and running state onto survivors.
  - ``heartbeat_stall``: replica ``rid`` stops stepping for
    ``hold_steps`` cluster ticks without raising, so the cluster's
    step-heartbeat health check must detect and evict it.
"""
from __future__ import annotations

import dataclasses
import random
from collections import Counter
from typing import Sequence

KINDS = ("alloc_hold", "sync_error", "slow_step", "callback_error",
         "crash", "replica_kill", "heartbeat_stall")


class FaultError(RuntimeError):
    """An injected *transient* fault (sync failure, callback raise)."""


class CrashError(RuntimeError):
    """An injected hard crash: the engine does not recover in-process;
    the process is expected to restore from a snapshot."""


@dataclasses.dataclass(frozen=True)
class Fault:
    """One entry in a fault schedule.

    Exactly one of ``step`` / ``rate`` selects the trigger: ``step >= 0``
    fires when the engine step counter equals it; otherwise each
    eligible opportunity fires with probability ``rate``.  ``times``
    bounds total firings of this spec.  ``rid >= 0`` restricts
    per-request kinds (``callback_error``) to that request id; for the
    cluster-scoped kinds (``replica_kill`` / ``heartbeat_stall``) the
    same field selects the target *replica* index and ``step`` counts
    cluster ticks.
    """

    kind: str
    step: int = -1
    rate: float = 0.0
    times: int = 1
    blocks: int = 0          # alloc_hold: 0 = half of currently-free
    hold_steps: int = 2      # alloc_hold: steps until blocks release
    #                          (heartbeat_stall: stalled cluster ticks)
    delay_s: float = 0.002   # slow_step: injected stall
    rid: int = -1            # callback_error: target request
    #                          (cluster kinds: target replica index)

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"expected one of {KINDS}")
        if self.step < 0 and not (0.0 < self.rate <= 1.0):
            raise ValueError(f"{self.kind}: need step >= 0 or rate in "
                             f"(0, 1], got step={self.step} "
                             f"rate={self.rate}")


class FaultInjector:
    """Evaluates a fault schedule at the engine's hook points.

    ``fire(kind, step, rid)`` returns the first eligible matching
    :class:`Fault` (and consumes one of its ``times``), or ``None``.
    ``fired`` counts firings per kind so tests can assert the schedule
    actually exercised what it claims to.
    """

    def __init__(self, faults: Sequence[Fault], seed: int = 0):
        self.faults = list(faults)
        self.seed = seed
        self._rng = random.Random(seed)
        self._used = [0] * len(self.faults)
        self.fired: Counter = Counter()

    def fire(self, kind: str, step: int, rid: int = -1) -> Fault | None:
        for i, f in enumerate(self.faults):
            if f.kind != kind or self._used[i] >= f.times:
                continue
            if f.rid >= 0 and rid != f.rid:
                continue
            if f.step >= 0:
                if f.step != step:
                    continue
            elif self._rng.random() >= f.rate:
                continue
            self._used[i] += 1
            self.fired[kind] += 1
            return f
        return None

    def reset(self) -> None:
        """Rewind to the initial state (same seed => same schedule)."""
        self._rng = random.Random(self.seed)
        self._used = [0] * len(self.faults)
        self.fired = Counter()
