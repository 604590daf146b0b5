"""Metric exporters: Prometheus text exposition format + JSON snapshot.

``prometheus_text`` renders a MetricsRegistry in the text format a
Prometheus scrape endpoint would serve — counters and gauges as single
samples, histograms as cumulative ``_bucket{le=...}`` series plus
``_sum``/``_count`` — so the registry can back a real ``/metrics``
endpoint later without re-plumbing (``launch/serve.py --metrics`` prints
it).  ``json_snapshot`` is the same data as one nested dict.  Names and
their ``repro_`` prefix are the JAX package's, so both packages export the
same text for the same registry.
"""
from __future__ import annotations

import json
import re

from repro_torch.obs.metrics import MetricsRegistry

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _sanitize(name: str, prefix: str = "repro_") -> str:
    return prefix + _NAME_RE.sub("_", name)


def _assign_names(reg: MetricsRegistry) -> dict[tuple[str, str], str]:
    """Collision-free exported name per metric.

    ``_sanitize`` is lossy — ``serve/steps`` and ``serve_steps`` both
    map to ``repro_serve_steps``, which would silently merge two
    distinct series into one scrape sample.  Walk every metric in its
    emission order, and when a sanitized name (counters compared
    *after* their ``_total`` suffix, which is part of the exposed
    series name) repeats, disambiguate with a ``_2``/``_3`` suffix —
    deterministic, first-seen keeps the clean name."""
    taken: set[str] = set()
    counts: dict[str, int] = {}
    out: dict[tuple[str, str], str] = {}
    for kind, names in (("counter", sorted(reg.counters)),
                        ("gauge", sorted(reg.gauges)),
                        ("histogram", sorted(reg.histograms))):
        suffix = "_total" if kind == "counter" else ""
        for name in names:
            base = _sanitize(name)
            cand = base
            while cand + suffix in taken:
                counts[base] = counts.get(base, 1) + 1
                cand = f"{base}_{counts[base]}"
            taken.add(cand + suffix)
            out[(kind, name)] = cand
    return out


def _fmt(v: float) -> str:
    if v == float("inf"):
        return "+Inf"
    return repr(int(v)) if float(v).is_integer() else repr(float(v))


def _esc(name: str) -> str:
    return name.replace("\\", "\\\\").replace("\n", "\\n")


def prometheus_text(reg: MetricsRegistry) -> str:
    names = _assign_names(reg)
    lines: list[str] = []
    for name in sorted(reg.counters):
        n = names[("counter", name)] + "_total"
        lines += [f"# HELP {n} {_esc(name)}", f"# TYPE {n} counter",
                  f"{n} {reg.counters[name].value}"]
    for name in sorted(reg.gauges):
        n = names[("gauge", name)]
        lines += [f"# HELP {n} {_esc(name)}", f"# TYPE {n} gauge",
                  f"{n} {_fmt(reg.gauges[name].value)}"]
    for name in sorted(reg.histograms):
        h = reg.histograms[name]
        n = names[("histogram", name)]
        lines += [f"# HELP {n} {_esc(name)}", f"# TYPE {n} histogram"]
        cum = 0
        for ub, c in zip(h.buckets, h.counts):
            cum += c
            lines.append(f'{n}_bucket{{le="{_fmt(ub)}"}} {cum}')
        lines.append(f'{n}_bucket{{le="+Inf"}} {h.count}')
        lines.append(f"{n}_sum {_fmt(h.total)}")
        lines.append(f"{n}_count {h.count}")
    return "\n".join(lines) + "\n"


def json_snapshot(reg: MetricsRegistry) -> dict:
    return reg.snapshot()


def write_snapshot(reg: MetricsRegistry, path: str) -> None:
    with open(path, "w") as f:
        json.dump(json_snapshot(reg), f, indent=1)
