"""The port's serving telemetry (``repro_torch.obs``), mirroring
``tests/test_obs.py``: telemetry must be invisible to the device — metrics-on
and metrics-off engines give byte-identical outputs on the dense and the
speculative paths, and telemetry never draws from the engine's generator —
while the host-side surfaces (histograms, lifecycle latency fields, Chrome
trace, Prometheus text) are right, the disabled path reads no clock, and the
port's copy exports exactly what the JAX package's ``obs`` exports for the
same events.

Reduced TinyLlama, f32, on the CPU (``device="cpu"`` asked for explicitly).
"""
import json
import time

import numpy as np
import pytest

from repro import obs as j_obs
from repro_torch import obs as t_obs
from repro_torch.configs import get_config, reduced
from repro_torch.core.pruner import prune_model
from repro_torch.models import build
from repro_torch.obs import (DEFAULT_TIME_BUCKETS, Histogram, MetricsRegistry,
                             Telemetry, json_snapshot, prometheus_text,
                             to_chrome)
from repro_torch.obs.trace import TraceBuffer
from repro_torch.serve import Engine, ServeConfig

_MODELS: dict = {}


def _build(pruned: bool = False):
    """(cfg, model, params) of reduced TinyLlama from seed 0; ``pruned`` =
    its 50 % L1-pruned draft."""
    if pruned not in _MODELS:
        cfg = reduced(get_config("tinyllama-1.1b"))
        m = build(cfg)
        params = m.init(0, device="cpu")
        if pruned:
            pr = prune_model(m, params, 0.5, criterion="l1")
            m, params = build(pr.cfg), pr.params
        _MODELS[pruned] = (cfg, m, params)
    return _MODELS[pruned]


def _prompts(cfg, n=4, base=9, seed=3):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(0, cfg.vocab_size,
                                          base - (i % 3))]
            for i in range(n)]


def _engine(sc, **kw):
    _, m, params = _build()
    return Engine(m, params, sc, device="cpu", **kw)


def _serve(eng, prompts, gen=8, temperature=0.0):
    rids = [eng.add_request(p, max_new_tokens=gen, temperature=temperature)
            for p in prompts]
    out, stats = eng.run()
    return [out[r].tokens for r in rids], stats


# ---------------------------------------------------------------------------
# Metric primitives
# ---------------------------------------------------------------------------

def test_counter_gauge_registry():
    reg = MetricsRegistry()
    c = reg.counter("serve/steps")
    assert reg.counter("serve/steps") is c       # get-or-create
    c.inc()
    c.inc(4)
    reg.counter("serve/decode_tokens").inc(7)
    reg.gauge("pool/free").set(3)
    assert reg.counter_values("serve/") == {"serve/steps": 5,
                                            "serve/decode_tokens": 7}
    assert reg.counter_values() == {"serve/steps": 5,
                                    "serve/decode_tokens": 7}
    snap = reg.snapshot()
    assert snap["gauges"]["pool/free"] == 3.0
    json.dumps(snap)                             # JSON-serializable as-is
    reg.reset()
    assert c.value == 0 and reg.gauge("pool/free").value == 0.0


def test_histogram_percentiles_uniform():
    """1..1000 into decade-ish buckets: interpolated p50/p90/p99 land within
    one bucket width of the exact order statistic."""
    buckets = tuple(float(b) for b in
                    (1, 2, 5, 10, 20, 50, 100, 200, 500, 1000))
    h = Histogram("t", buckets)
    for v in range(1, 1001):
        h.observe(float(v))
    s = h.summary()
    assert s["count"] == 1000 and s["min"] == 1.0 and s["max"] == 1000.0
    assert s["mean"] == pytest.approx(500.5)
    assert 200 <= s["p50"] <= 500
    assert 500 <= s["p90"] <= 1000
    assert s["p99"] > s["p90"] >= s["p50"]
    assert abs(s["p50"] - 500) <= 300            # within the winning bucket
    assert abs(s["p90"] - 900) <= 500
    assert h.percentile(0) == 1.0
    assert h.percentile(100) == 1000.0


def test_histogram_single_value_and_overflow():
    h = Histogram("t", (1.0, 2.0))
    h.observe(1.5)
    s = h.summary()
    assert s["p50"] == s["p90"] == s["p99"] == 1.5
    h.observe(99.0)                              # lands in +inf overflow
    assert h.counts[-1] == 1
    assert h.percentile(99) <= 99.0              # clamped to observed max
    assert h.summary()["max"] == 99.0


def test_histogram_default_buckets_cover_phase_times():
    h = Histogram("t")
    assert h.buckets == DEFAULT_TIME_BUCKETS
    assert h.buckets[0] == pytest.approx(1e-6)
    assert h.buckets[-1] > 30.0                  # a cold first step fits
    h.observe(0.003)
    assert h.summary()["count"] == 1


def test_prometheus_text_format():
    reg = MetricsRegistry()
    reg.counter("serve/steps").inc(3)
    reg.gauge("pool/hit-rate").set(0.5)
    h = reg.histogram("phase/sync", (0.001, 0.01))
    h.observe(0.0005)
    h.observe(0.5)
    text = prometheus_text(reg)
    assert "repro_serve_steps_total 3" in text
    assert "repro_pool_hit_rate 0.5" in text     # '-' and '/' sanitized
    assert 'repro_phase_sync_bucket{le="0.001"} 1' in text
    assert 'repro_phase_sync_bucket{le="0.01"} 1' in text
    assert 'repro_phase_sync_bucket{le="+Inf"} 2' in text
    assert "repro_phase_sync_count 2" in text
    assert json_snapshot(reg)["counters"]["serve/steps"] == 3


def test_prometheus_name_collisions_disambiguated():
    """Sanitizing is lossy (serve/steps and serve_steps both map to
    repro_serve_steps): colliding metrics get distinct exported series, and
    every series carries a HELP line naming its original metric."""
    reg = MetricsRegistry()
    reg.counter("serve/steps").inc(1)
    reg.counter("serve_steps").inc(2)
    reg.counter("serve-steps").inc(4)
    reg.gauge("pool/free").set(7)
    reg.gauge("pool_free").set(9)
    lines = prometheus_text(reg).splitlines()
    samples = {ln.split()[0]: ln.split()[1] for ln in lines
               if ln and not ln.startswith("#") and "{" not in ln}
    counter_vals = sorted(int(v) for n, v in samples.items()
                          if n.startswith("repro_serve") and
                          n.endswith("_total"))
    assert counter_vals == [1, 2, 4]
    assert len({n for n in samples if n.startswith("repro_serve")}) == 3
    gauge_vals = sorted(int(v) for n, v in samples.items()
                        if n.startswith("repro_pool"))
    assert gauge_vals == [7, 9]
    helps = {ln.split()[2]: ln.split(None, 3)[3] for ln in lines
             if ln.startswith("# HELP")}
    assert set(helps.values()) >= {"serve/steps", "serve_steps",
                                   "serve-steps", "pool/free", "pool_free"}
    assert len(helps) == len(set(helps))         # exported names unique
    assert helps["repro_serve_steps_total"] in ("serve/steps",
                                                "serve-steps")
    assert any(n.startswith("repro_serve_steps_2") for n in helps)


def test_trace_buffer_is_bounded_ring():
    """Each event kind is a bounded ring that drops the OLDEST events and
    counts the drops."""
    buf = TraceBuffer(capacity=8)
    for i in range(20):
        buf.add_phase(i, "step", float(i), float(i) + 0.5)
        buf.add_span(i, "submit", float(i))
        buf.add_counter("pool", {"free": float(i)}, t=float(i))
    assert len(buf.phases) == 8 and len(buf.spans) == 8
    assert len(buf.counters) == 8
    assert buf.dropped_events == 3 * 12          # oldest 12 of each kind
    assert buf.phases[0].step == 12              # most recent window kept
    assert buf.phases[-1].step == 19
    buf.clear()
    assert buf.dropped_events == 0 and not buf.phases
    assert TraceBuffer().capacity == 65536


class _FakeClock:
    """A clock that advances 1.25 ms per read and counts its reads."""

    def __init__(self):
        self.reads = 0

    def __call__(self) -> float:
        self.reads += 1
        return 100.0 + 0.00125 * self.reads


def _scripted(pkg) -> tuple[str, str]:
    """The same events, phases, gauges and histograms through one
    ``Telemetry`` of ``pkg`` under a fake clock; (Prometheus text, Chrome
    JSON)."""
    tel = pkg.Telemetry(enabled=True, clock=_FakeClock())
    tel.trace.set_track_name(1, "replica 1")
    for step in range(3):
        with tel.phase("step", step):
            with tel.phase("plan", step):
                pass
            tel.event("submit", step)
            tel.event("admit", step)
            with tel.phase("sync", step):
                tel.observe("latency/ttft_s", 0.01 * (step + 1),
                            buckets=pkg.DEFAULT_TIME_BUCKETS)
            tel.sample("pool", {"free": 10 - step, "live": step})
        tel.event("finish", step, reason="length")
    tel.event("submit", 9)                       # left dangling
    tel.observe("spec/accepted_per_cycle", 2.0, buckets=(0.0, 1.0, 2.0))
    tel.registry.counter("serve/steps").inc(3)
    tel.registry.counter("serve_steps").inc(1)   # a name collision
    tel.trace.add_phase(3, "fold", 100.5, 100.6, track=1)
    return (pkg.prometheus_text(tel.registry),
            json.dumps(pkg.to_chrome(tel.trace), sort_keys=True))


def test_exports_equal_the_reference_packages():
    """``repro_torch.obs`` is a copy of the JAX package's ``obs``: the same
    scripted events under the same fake clock export the same Prometheus
    text and the same Chrome trace."""
    t_text, t_trace = _scripted(t_obs)
    j_text, j_trace = _scripted(j_obs)
    assert t_text == j_text
    assert t_trace == j_trace
    assert "repro_serve_steps_2_total" in t_text
    assert json.loads(t_trace)["traceEvents"]


# ---------------------------------------------------------------------------
# Byte parity: telemetry must not perturb outputs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_metrics_on_off_byte_identical_dense(temperature):
    """Same seed, same requests: outputs (greedy AND sampled — telemetry
    must not touch the engine's generator) are byte-identical with metrics
    on."""
    cfg, _, _ = _build()
    prompts = _prompts(cfg)
    sc = ServeConfig(max_seqs=2, block_size=4, max_len=32)
    off, s_off = _serve(_engine(sc), prompts, temperature=temperature)
    tel = Telemetry(enabled=True)
    on, s_on = _serve(_engine(sc, telemetry=tel), prompts,
                      temperature=temperature)
    assert on == off
    for k in ("steps", "decode_tokens", "prefill_chunks", "host_syncs"):
        assert s_on[k] == s_off[k], k
    assert tel.registry.histograms["phase/step"].count >= s_on["steps"]
    assert tel.registry.counters["lifecycle/finish"].value == len(prompts)
    assert tel.registry.histograms["latency/ttft_s"].count == len(prompts)
    assert tel.registry.histograms["latency/itl_s"].count == \
        s_on["decode_tokens"] - len(prompts)


def test_metrics_on_off_byte_identical_spec():
    cfg, m, params = _build()
    _, dm, dp = _build(pruned=True)
    prompts = _prompts(cfg)
    sc = ServeConfig(max_seqs=2, block_size=4, max_len=40, spec_k=3)
    off, s_off = _serve(_engine(sc, draft_model=dm, draft_params=dp),
                        prompts)
    tel = Telemetry(enabled=True)
    eng = _engine(sc, draft_model=dm, draft_params=dp, telemetry=tel)
    assert eng.spec_active
    on, s_on = _serve(eng, prompts)
    assert on == off
    assert s_on["spec_proposed"] == s_off["spec_proposed"]
    assert s_on["spec_accepted"] == s_off["spec_accepted"]
    assert s_on["host_syncs"] == s_off["host_syncs"]
    # acceptance histograms recorded per drafted slot-cycle; their mass
    # reconciles with the run counter
    acc = tel.registry.histograms["spec/accepted_per_cycle"]
    assert acc.count > 0
    assert acc.total == s_on["spec_accepted"]
    assert tel.registry.histograms["spec/acceptance_rate"].count == \
        acc.count


# ---------------------------------------------------------------------------
# Lifecycle latency fields (queue wait, preempt stall, manual-step TTFT)
# ---------------------------------------------------------------------------

def test_queue_wait_recorded_under_slot_pressure():
    """More requests than slots: late requests wait for a slot, and that
    wait shows up in both queue_wait_s and ttft_s."""
    cfg, _, _ = _build()
    eng = _engine(ServeConfig(max_seqs=2, block_size=4, max_len=32))
    rids = [eng.add_request(p, max_new_tokens=8)
            for p in _prompts(cfg, n=5)]
    out, _ = eng.run()
    for r in rids:
        assert out[r].ttft_s >= out[r].queue_wait_s >= 0.0
    # FCFS: the last request cannot start before an earlier one frees a
    # slot, so it has measurably waited
    assert out[rids[-1]].queue_wait_s > 0.0
    assert out[rids[0]].queue_wait_s <= out[rids[-1]].queue_wait_s


def test_preempt_stall_recorded():
    """A pool too small for all requests forces eviction; the evicted
    request's time off the engine is charged to preempt_stall_s, and the
    trace records preempt / resume."""
    cfg, _, _ = _build()
    rng = np.random.default_rng(5)
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size, 9)]
               for _ in range(4)]
    tel = Telemetry(enabled=True)
    eng = _engine(ServeConfig(max_seqs=4, block_size=4, max_len=64,
                              num_blocks=13), telemetry=tel)
    rids = [eng.add_request(p, max_new_tokens=12) for p in prompts]
    out, _ = eng.run()
    preempted = [r for r in rids if out[r].preemptions > 0]
    assert preempted                             # pressure was real
    for r in preempted:
        assert out[r].preempt_stall_s > 0.0
    for r in rids:
        if out[r].preemptions == 0:
            assert out[r].preempt_stall_s == 0.0
    n = sum(out[r].preemptions for r in rids)
    assert tel.registry.counters["lifecycle/preempt"].value == n
    assert tel.registry.counters["lifecycle/resume"].value == n


def test_ttft_correct_under_manual_step_driving():
    """Drive the engine with step() after an idle gap: TTFT spans submit ->
    first token, and stays inside the window from submission to the last
    step, read on the same clock."""
    cfg, _, _ = _build()
    eng = _engine(ServeConfig(max_seqs=2, block_size=4, max_len=32))
    t_sub = time.time()
    rids = [eng.add_request(p, max_new_tokens=4)
            for p in _prompts(cfg, n=2)]
    gap = 0.05
    time.sleep(gap)                              # the queue sits idle
    while eng.scheduler.has_work:
        eng.step()
    t_end = time.time()
    recs = eng.finished()
    assert sorted(recs) == sorted(rids)
    for r in rids:
        assert recs[r].ttft_s >= gap
        assert recs[r].ttft_s <= t_end - t_sub
        assert recs[r].tpot_s >= 0.0
    # finished() is non-destructive; run() on the not-yet-drained engine
    # reports them once, and after that drain nothing reports again
    recs2 = eng.finished()
    assert {r: recs2[r].ttft_s for r in recs2} == \
           {r: recs[r].ttft_s for r in recs}
    out, _ = eng.run()
    assert sorted(out) == sorted(rids)
    assert eng.run()[0] == {}


def test_run_stats_keys_superset():
    """The run stats keep every key the port reported before telemetry and
    the reference's serving keys."""
    cfg, _, _ = _build()
    eng = _engine(ServeConfig(max_seqs=2, block_size=4, max_len=32))
    _, stats = _serve(eng, _prompts(cfg, n=2))
    for k in ("wall_s", "steps", "decode_tokens", "prefill_tokens",
              "decode_tok_per_s", "total_tok_per_s", "prefill_chunks",
              "cow_copies", "host_syncs", "decode_calls", "prefill_calls",
              "mean_ttft_s", "spec_cycles", "spec_proposed",
              "spec_accepted", "spec_acceptance"):
        assert k in stats, k
    assert stats["host_syncs"] == stats["steps"]  # ONE fetch per step
    assert stats["spec_cycles"] == 0 and stats["spec_acceptance"] == 0.0
    # run()'s stats are a diff of the registry's counters
    assert eng.obs.registry.counter_values("serve/")["serve/steps"] == \
        int(stats["steps"])


# ---------------------------------------------------------------------------
# Chrome trace schema
# ---------------------------------------------------------------------------

def _traced_run(n=4):
    cfg, _, _ = _build()
    tel = Telemetry(enabled=True)
    eng = _engine(ServeConfig(max_seqs=2, block_size=4, max_len=32),
                  telemetry=tel)
    _serve(eng, _prompts(cfg, n=n))
    return tel, to_chrome(tel.trace)


def test_chrome_trace_schema():
    _, doc = _traced_run()
    assert doc["displayTimeUnit"] == "ms"
    ev = doc["traceEvents"]
    json.dumps(doc)                              # serializable
    assert {e["ph"] for e in ev} >= {"M", "X", "b", "e", "n", "C"}
    for e in ev:
        assert e["ts"] >= 0 if "ts" in e else True
    xs = [e for e in ev if e["ph"] == "X"]
    assert all(e["dur"] >= 0 and e["pid"] == 0 and e["tid"] == 0
               for e in xs)
    assert {e["name"] for e in xs} >= {"step", "plan", "prefill_dispatch",
                                       "decode_dispatch", "sync", "fold"}
    counters = [e for e in ev if e["ph"] == "C"]
    assert any(e["name"] == "pool" for e in counters)
    assert any(e["name"] == "prefix" for e in counters)
    assert any(e["name"] == "engine" for e in counters)
    for e in counters:
        assert all(isinstance(v, (int, float)) for v in e["args"].values())


def test_chrome_trace_phases_nest_inside_step():
    """Chrome nests same-tid X events by time containment: every inner
    phase slice sits inside its step's enclosing slice."""
    _, doc = _traced_run()
    xs = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    steps = {e["args"]["step"]: e for e in xs if e["name"] == "step"}
    inner = [e for e in xs if e["name"] != "step"]
    assert steps and inner
    eps = 1.0                                    # us; clock granularity
    for e in inner:
        outer = steps[e["args"]["step"]]
        assert e["ts"] >= outer["ts"] - eps, e["name"]
        assert e["ts"] + e["dur"] <= outer["ts"] + outer["dur"] + eps, \
            e["name"]


def test_chrome_trace_spans_open_and_close():
    _, doc = _traced_run()
    ev = doc["traceEvents"]
    opens = {e["id"] for e in ev if e["ph"] == "b"}
    closes = {e["id"] for e in ev if e["ph"] == "e"}
    assert opens and opens == closes             # every span closes
    for rid in opens:
        ts = {ph: [e["ts"] for e in ev
                   if e["ph"] == ph and e.get("id") == rid]
              for ph in ("b", "n", "e")}
        assert len(ts["b"]) == 1 and len(ts["e"]) == 1
        assert ts["n"], "lifecycle instants missing"
        assert ts["b"][0] <= min(ts["n"]) and max(ts["n"]) <= ts["e"][0]
    kinds = {e["args"]["kind"] for e in ev if e["ph"] == "n"}
    assert {"admit", "first_chunk", "first_token"} <= kinds
    assert {e["args"].get("reason") for e in ev if e["ph"] == "e"} == \
        {"length"}


def test_chrome_trace_closes_dangling_spans():
    """A request still in flight at export time gets a synthetic close so
    the trace always validates."""
    buf = TraceBuffer()
    buf.add_span(7, "submit")
    buf.add_span(7, "admit")
    es = [e for e in to_chrome(buf)["traceEvents"] if e["ph"] == "e"]
    assert len(es) == 1 and es[0]["id"] == 7
    assert es[0]["args"]["kind"] == "eof"


# ---------------------------------------------------------------------------
# Disabled path: records nothing, reads no clock
# ---------------------------------------------------------------------------

def test_disabled_telemetry_records_nothing():
    cfg, _, _ = _build()
    eng = _engine(ServeConfig(max_seqs=2, block_size=4, max_len=32))
    assert eng.obs.enabled is False              # the default
    _serve(eng, _prompts(cfg, n=2))
    assert not eng.obs.trace.phases and not eng.obs.trace.spans
    assert not eng.obs.registry.histograms and not eng.obs.registry.gauges
    # only the always-on run counters exist
    assert all(k.startswith("serve/") for k in eng.obs.registry.counters)


def test_disabled_path_reads_no_clock():
    """The reference bounds the disabled path's cost by wall clock; the
    port counts instead: after the handle is built (its trace epoch is one
    read), neither the gated calls nor a whole speculative engine run read
    its clock."""
    clock = _FakeClock()
    tel = Telemetry(enabled=False, clock=clock)
    built = clock.reads
    for _ in range(100):
        with tel.phase("x"):
            pass
        tel.event("e", 0)
        tel.sample("g", {"a": 1.0})
        tel.observe("h", 0.0)
    cfg, _, _ = _build()
    _, dm, dp = _build(pruned=True)
    eng = _engine(ServeConfig(max_seqs=2, block_size=4, max_len=40,
                              spec_k=3), draft_model=dm, draft_params=dp,
                  telemetry=tel)
    _, stats = _serve(eng, _prompts(cfg, n=3))
    assert stats["spec_cycles"] > 0
    assert clock.reads == built
    assert not tel.trace.phases and not tel.registry.histograms
