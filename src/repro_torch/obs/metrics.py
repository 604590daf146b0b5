"""Low-overhead serving metrics: counters, gauges, fixed-bucket histograms.

Everything here is host-side Python over plain ints/floats — nothing in
this module may ever touch a tensor, a device call, or the engine's
generator, so enabling metrics cannot perturb device work or outputs
(asserted byte-for-byte in tests/test_torch_obs.py).  A copy of the JAX
package's ``obs/metrics.py``: the port imports nothing of that package.

Three metric kinds:

  - ``Counter``: monotonically increasing int.  The engine's own run
    statistics are registry counters (``Engine.run`` diffs a
    ``counter_values()`` snapshot instead of hand-rolled ``x0`` locals),
    so counters are ALWAYS live — an ``inc()`` is one integer add, the
    exact cost of the attribute increments they replaced.
  - ``Gauge``: last-written float (pool occupancy, hit rates).
  - ``Histogram``: fixed-bucket counts with interpolated percentile
    summaries (p50/p90/p99).  Buckets are chosen at creation and never
    rebalance, so ``observe`` is one bisect + one add; percentiles are
    exact to within one bucket's width (tested on known samples).

The *optional* instrumentation — phase timers, lifecycle spans, per-step
gauge sampling — is gated by ``Telemetry.enabled`` (see
``repro_torch.obs.Telemetry``); that is the no-op path, which reads no
clock (tests/test_torch_obs.py).
"""
from __future__ import annotations

from bisect import bisect_left

# geometric 1us .. ~34s: wide enough for a phase timer on anything from
# a host dict update to a cold compile, at ~2x resolution
DEFAULT_TIME_BUCKETS: tuple[float, ...] = tuple(
    1e-6 * 2.0 ** i for i in range(26))


class Counter:
    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n

    def reset(self) -> None:
        self.value = 0


class Gauge:
    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def reset(self) -> None:
        self.value = 0.0


class Histogram:
    """Fixed upper-bound buckets plus an implicit +inf overflow bucket.

    ``percentile`` linearly interpolates inside the winning bucket
    (clamped by the observed min/max, so the extremes of the summary are
    exact even when the tail bucket is wide).
    """

    __slots__ = ("name", "buckets", "counts", "count", "total",
                 "vmin", "vmax")

    def __init__(self, name: str, buckets: tuple[float, ...] = ()):
        self.name = name
        self.buckets = tuple(sorted(buckets)) or DEFAULT_TIME_BUCKETS
        self.counts = [0] * (len(self.buckets) + 1)
        self.count = 0
        self.total = 0.0
        self.vmin = float("inf")
        self.vmax = float("-inf")

    def observe(self, v: float) -> None:
        self.counts[bisect_left(self.buckets, v)] += 1
        self.count += 1
        self.total += v
        if v < self.vmin:
            self.vmin = v
        if v > self.vmax:
            self.vmax = v

    def percentile(self, q: float) -> float:
        """Interpolated q-th percentile (q in [0, 100]) of the observed
        samples; exact to within the winning bucket's width."""
        if not self.count:
            return 0.0
        target = q / 100.0 * self.count
        cum = 0
        for i, c in enumerate(self.counts):
            if not c:
                continue
            lo = self.buckets[i - 1] if i > 0 else self.vmin
            hi = self.buckets[i] if i < len(self.buckets) else self.vmax
            if cum + c >= target:
                frac = min(max((target - cum) / c, 0.0), 1.0)
                v = lo + frac * (hi - lo)
                return min(max(v, self.vmin), self.vmax)
            cum += c
        return self.vmax

    def summary(self) -> dict[str, float]:
        if not self.count:
            return {"count": 0, "sum": 0.0, "mean": 0.0, "min": 0.0,
                    "max": 0.0, "p50": 0.0, "p90": 0.0, "p99": 0.0}
        return {"count": self.count, "sum": self.total,
                "mean": self.total / self.count,
                "min": self.vmin, "max": self.vmax,
                "p50": self.percentile(50), "p90": self.percentile(90),
                "p99": self.percentile(99)}

    def reset(self) -> None:
        self.counts = [0] * (len(self.buckets) + 1)
        self.count = 0
        self.total = 0.0
        self.vmin = float("inf")
        self.vmax = float("-inf")


class MetricsRegistry:
    """Name-keyed get-or-create store for the three metric kinds.

    One registry serves one engine (or one test); names are free-form
    ``group/name`` strings, sanitized only at export time
    (repro_torch.obs.export).
    """

    def __init__(self):
        self.counters: dict[str, Counter] = {}
        self.gauges: dict[str, Gauge] = {}
        self.histograms: dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        c = self.counters.get(name)
        if c is None:
            c = self.counters[name] = Counter(name)
        return c

    def gauge(self, name: str) -> Gauge:
        g = self.gauges.get(name)
        if g is None:
            g = self.gauges[name] = Gauge(name)
        return g

    def histogram(self, name: str,
                  buckets: tuple[float, ...] = ()) -> Histogram:
        h = self.histograms.get(name)
        if h is None:
            h = self.histograms[name] = Histogram(name, buckets)
        return h

    def counter_values(self, prefix: str = "") -> dict[str, int]:
        """Snapshot of every counter (optionally name-filtered) — the
        registry-backed replacement for Engine.run()'s delta locals."""
        return {k: c.value for k, c in self.counters.items()
                if k.startswith(prefix)}

    def snapshot(self) -> dict:
        """Nested plain-dict snapshot (JSON-serializable as-is)."""
        return {
            "counters": {k: c.value for k, c in self.counters.items()},
            "gauges": {k: g.value for k, g in self.gauges.items()},
            "histograms": {k: h.summary()
                           for k, h in self.histograms.items()},
        }

    def reset(self) -> None:
        for group in (self.counters, self.gauges, self.histograms):
            for m in group.values():
                m.reset()
