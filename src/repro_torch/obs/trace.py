"""Structured trace events and the Chrome-trace/Perfetto exporter.

The engine records three raw event kinds into a ``TraceBuffer`` (host
wall clock only — never inside a device call, and no device
synchronization of its own):

  - **phase events**: (step, name, t0, t1) — one per engine-step phase
    (plan / prefill_dispatch / decode_dispatch / sync / fold), and an
    enclosing ``step`` phase they nest inside;
  - **span events**: (rid, kind, t) — per-request lifecycle points
    (submit, admit, first_chunk, first_token, preempt, resume, finish);
  - **counter samples**: (t, name, values) — pool occupancy and prefix
    hit-rate gauges sampled once per step.

``to_chrome`` renders these as a Chrome trace (the Trace Event Format
Perfetto and chrome://tracing load): phases become complete ("X")
duration events on one engine thread, where same-tid events nest by
time containment — so each phase slice appears under its step slice;
requests become async ("b"/"n"/"e") events keyed by rid, one track per
request; counter samples become "C" events, which Perfetto draws as
stacked area charts over time.  Timestamps are microseconds relative to
the buffer's epoch.
"""
from __future__ import annotations

import dataclasses
import json
import time
from collections import deque


@dataclasses.dataclass(frozen=True)
class PhaseEvent:
    step: int
    name: str
    t0: float
    t1: float
    # Chrome-trace thread the phase renders on.  Track 0 is the classic
    # single-engine "engine step" thread; a cluster gives each replica
    # its own track so one trace shows N step timelines side by side.
    track: int = 0


@dataclasses.dataclass(frozen=True)
class SpanEvent:
    rid: int
    kind: str
    t: float
    # extra key/value metadata, stored as a sorted tuple of pairs so the
    # event stays hashable/frozen; "finish" spans carry the terminal
    # reason here (shed vs deadline vs cancelled vs completed — the
    # trace must distinguish them)
    meta: tuple = ()


@dataclasses.dataclass(frozen=True)
class CounterSample:
    t: float
    name: str
    values: dict[str, float]


# lifecycle kinds that open / close a request's async span; everything
# else is an instant on the open span
SPAN_OPEN = "submit"
SPAN_CLOSE = "finish"


class TraceBuffer:
    """Bounded ring of trace events.

    A long-lived server records phases/spans/counters on every step
    forever; an unbounded list is a slow host-memory leak.  Each event
    kind keeps at most ``capacity`` entries — overflow drops the
    *oldest* event (the exported trace keeps the most recent window,
    which is what you want when attaching to a misbehaving server) and
    counts it in ``dropped_events``, so a truncated export is
    detectable rather than silently partial."""

    def __init__(self, clock=time.perf_counter, capacity: int = 65536):
        self.clock = clock
        self.epoch = clock()
        self.capacity = capacity
        self.phases: deque[PhaseEvent] = deque(maxlen=capacity)
        self.spans: deque[SpanEvent] = deque(maxlen=capacity)
        self.counters: deque[CounterSample] = deque(maxlen=capacity)
        self.dropped_events = 0
        self._track_names: dict[int, str] = {0: "engine step"}

    def now(self) -> float:
        return self.clock()

    def _push(self, dq: deque, ev) -> None:
        if len(dq) == dq.maxlen:
            self.dropped_events += 1
        dq.append(ev)

    def set_track_name(self, track: int, name: str) -> None:
        """Label a phase track (rendered as a thread name in the Chrome
        export — clusters name one track per replica)."""
        self._track_names[track] = name

    def add_phase(self, step: int, name: str, t0: float, t1: float,
                  track: int = 0) -> None:
        self._push(self.phases, PhaseEvent(step, name, t0, t1, track))

    def add_span(self, rid: int, kind: str, t: float | None = None,
                 **meta) -> None:
        self._push(self.spans,
                   SpanEvent(rid, kind, self.clock() if t is None else t,
                             tuple(sorted(meta.items()))))

    def add_counter(self, name: str, values: dict[str, float],
                    t: float | None = None) -> None:
        self._push(self.counters, CounterSample(
            self.clock() if t is None else t, name, dict(values)))

    def clear(self) -> None:
        self.phases.clear()
        self.spans.clear()
        self.counters.clear()
        self.dropped_events = 0


def to_chrome(buf: TraceBuffer) -> dict:
    """Render a TraceBuffer as a Chrome-trace dict (Trace Event Format).

    Every request span is closed: a request still in flight at export
    time gets its "e" event at the buffer's last-seen timestamp, so the
    JSON always validates (spans close; tested in tests/test_torch_obs.py).
    The process label is the reference's, so that both packages export
    the same trace for the same events.
    """
    us = lambda t: (t - buf.epoch) * 1e6          # noqa: E731
    ev: list[dict] = [
        {"ph": "M", "name": "process_name", "pid": 0,
         "args": {"name": "repro.serve engine"}},
    ]
    tracks = set(buf._track_names) | {p.track for p in buf.phases}
    for tid in sorted(tracks):
        ev.append({"ph": "M", "name": "thread_name", "pid": 0, "tid": tid,
                   "args": {"name": buf._track_names.get(
                       tid, f"replica {tid}")}})
    last_t = buf.epoch
    for p in buf.phases:
        ev.append({"ph": "X", "pid": 0, "tid": p.track, "name": p.name,
                   "cat": "phase", "ts": us(p.t0),
                   "dur": max(us(p.t1) - us(p.t0), 0.0),
                   "args": {"step": p.step}})
        last_t = max(last_t, p.t1)
    open_spans: set[int] = set()
    for s in buf.spans:
        last_t = max(last_t, s.t)
        ph = ("b" if s.kind == SPAN_OPEN
              else "e" if s.kind == SPAN_CLOSE else "n")
        if s.kind == SPAN_OPEN:
            open_spans.add(s.rid)
        elif s.kind == SPAN_CLOSE:
            open_spans.discard(s.rid)
        ev.append({"ph": ph, "pid": 0, "cat": "request",
                   "id": s.rid, "name": f"req {s.rid}", "ts": us(s.t),
                   "args": {"kind": s.kind, **dict(s.meta)}})
    for rid in sorted(open_spans):                # close dangling spans
        ev.append({"ph": "e", "pid": 0, "cat": "request", "id": rid,
                   "name": f"req {rid}", "ts": us(last_t),
                   "args": {"kind": "eof"}})
    for c in buf.counters:
        ev.append({"ph": "C", "pid": 0, "name": c.name, "ts": us(c.t),
                   "args": c.values})
    return {"traceEvents": ev, "displayTimeUnit": "ms"}


def write_chrome(buf: TraceBuffer, path: str) -> None:
    with open(path, "w") as f:
        json.dump(to_chrome(buf), f)
