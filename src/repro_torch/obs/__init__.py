"""`repro_torch.obs` — serving telemetry, the port's own copy of the JAX
package's ``obs/`` (pure Python; it imports nothing of that package).

One ``Telemetry`` handle threads through the serving stack
(``Engine(..., telemetry=...)``) and owns the three observability
surfaces:

  - a ``MetricsRegistry`` of counters / gauges / histograms
    (repro_torch.obs.metrics).  The engine's core run counters live here
    unconditionally — they replaced equally-cheap attribute increments
    and ``Engine.run``'s stats are diffs of them;
  - per-step **phase timers** and per-request **lifecycle spans**
    recorded into a ``TraceBuffer`` (repro_torch.obs.trace), exported as a
    Chrome-trace/Perfetto JSON;
  - per-step **pool gauges** (allocator occupancy, prefix hit rate)
    recorded both as registry gauges and as trace counter samples.

The disabled path (``enabled=False``, the engine default) is a no-op:
``phase()`` returns one shared null context manager, ``event()`` and
``sample()`` return after a single attribute check, and no clock is
read.  Instrumentation is host-side only by construction — nothing in
this package may touch a tensor, a device call, or the engine's
generator, and it adds no device synchronization (a phase timer reads the
host clock around the calls the engine makes anyway; the ``sync`` phase
is the step's one fetch) — which is why metrics-on and metrics-off engine
outputs are byte-identical (tests/test_torch_obs.py).
"""
from __future__ import annotations

import time

from repro_torch.obs.export import (json_snapshot, prometheus_text,
                              write_snapshot)
from repro_torch.obs.metrics import (DEFAULT_TIME_BUCKETS, Counter, Gauge,
                               Histogram, MetricsRegistry)
from repro_torch.obs.trace import TraceBuffer, to_chrome, write_chrome


class _NullCtx:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL_CTX = _NullCtx()


class _PhaseTimer:
    """Times one engine-step phase: histogram observe + trace event."""

    __slots__ = ("tel", "name", "step", "t0")

    def __init__(self, tel: "Telemetry", name: str, step: int):
        self.tel = tel
        self.name = name
        self.step = step

    def __enter__(self):
        self.t0 = self.tel.trace.now()
        return self

    def __exit__(self, *exc):
        t1 = self.tel.trace.now()
        self.tel.registry.histogram("phase/" + self.name).observe(
            t1 - self.t0)
        self.tel.trace.add_phase(self.step, self.name, self.t0, t1,
                                 track=self.tel.track)
        return False


class Telemetry:
    """One observability handle.

    ``trace``/``track`` support replicated serving: a cluster builds one
    shared :class:`TraceBuffer` and hands each replica its own Telemetry
    view (``Telemetry(trace=shared, track=i)``) — phases from every
    replica land in one Chrome trace on separate tracks, while each view
    keeps a *private* MetricsRegistry (an engine's ``reset()``/restore
    rewrites its counters, which must not clobber cluster totals)."""

    def __init__(self, enabled: bool = True, clock=time.perf_counter,
                 trace: TraceBuffer | None = None, track: int = 0):
        self.enabled = enabled
        self.registry = MetricsRegistry()
        self.trace = trace if trace is not None else TraceBuffer(clock=clock)
        self.track = track

    def phase(self, name: str, step: int = 0):
        """Context manager timing one step phase; null when disabled."""
        if not self.enabled:
            return NULL_CTX
        return _PhaseTimer(self, name, step)

    def event(self, kind: str, rid: int, **meta) -> None:
        """One request-lifecycle point (submit/admit/first_chunk/
        first_token/preempt/resume/finish).  ``meta`` rides on the trace
        span — finish events carry their terminal ``reason`` so traces
        distinguish shed / deadline / cancelled / completed."""
        if not self.enabled:
            return
        self.trace.add_span(rid, kind, **meta)
        self.registry.counter("lifecycle/" + kind).inc()

    def sample(self, name: str, values: dict[str, float]) -> None:
        """One gauge-group sample: registry gauges + a trace counter
        event (Perfetto draws these as occupancy-over-time charts)."""
        if not self.enabled:
            return
        for k, v in values.items():
            self.registry.gauge(f"{name}/{k}").set(v)
        self.trace.add_counter(name, values)

    def observe(self, name: str, value: float,
                buckets: tuple[float, ...] = ()) -> None:
        """Histogram observe, gated (use for optional distributions —
        spec acceptance, TTFT — not for the always-on run counters)."""
        if not self.enabled:
            return
        self.registry.histogram(name, buckets).observe(value)


__all__ = ["Telemetry", "MetricsRegistry", "Counter", "Gauge", "Histogram",
           "TraceBuffer", "DEFAULT_TIME_BUCKETS", "NULL_CTX", "to_chrome",
           "write_chrome", "prometheus_text", "json_snapshot",
           "write_snapshot"]
