"""Process-local counters, gauges, and latency histograms (the port's own
copy of the reference's ``obs/metrics.py``; standard library only).

The metric surface the serving/stream/kernel layers record into::

    from repro_torch.obs import metrics

    metrics.inc("serve.requests", 3)
    metrics.observe("serve.flush_s", 0.012, shape="(256,64)")
    metrics.gauge("stream.staleness_chunks", 4, sid="stream-0")

Series are keyed by (name, sorted labels). Histograms keep running
count/sum plus a bounded reservoir of recent values, from which
:func:`snapshot` derives p50/p95/p99 summaries. Exports:

  * :func:`snapshot` — a plain dict (JSON-safe) of every series.
  * :func:`to_prometheus_text` — the Prometheus text exposition format.

Recording is gated on :func:`repro_torch.obs.trace.enabled` — one flag test
when telemetry is off — and guarded by a process lock when on, so
snapshots are stable under concurrent serving sessions. Spans feed the
same histograms (``span.<name>_s``) on exit.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional, Tuple

from . import trace

_RESERVOIR = 2048

_lock = threading.Lock()
_counters: Dict[Tuple, float] = {}
_gauges: Dict[Tuple, float] = {}
_hists: Dict[Tuple, "_Hist"] = {}


class _Hist:
    __slots__ = ("count", "total", "values", "_i")

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.values: list = []
        self._i = 0

    def add(self, v: float) -> None:
        self.count += 1
        self.total += v
        if len(self.values) < _RESERVOIR:
            self.values.append(v)
        else:  # overwrite oldest (ring)
            self.values[self._i] = v
            self._i = (self._i + 1) % _RESERVOIR


def _key(name: str, labels: Dict[str, Any]) -> Tuple:
    return (name,) + tuple(sorted((k, str(v)) for k, v in labels.items()))


def inc(name: str, value: float = 1.0, **labels) -> None:
    """Add ``value`` to a monotonically increasing counter."""
    if not trace.enabled():
        return
    k = _key(name, labels)
    with _lock:
        _counters[k] = _counters.get(k, 0.0) + value


def gauge(name: str, value: float, **labels) -> None:
    """Set a last-value-wins gauge."""
    if not trace.enabled():
        return
    k = _key(name, labels)
    with _lock:
        _gauges[k] = float(value)


def observe(name: str, value: float, **labels) -> None:
    """Record one observation into a histogram series."""
    if not trace.enabled():
        return
    k = _key(name, labels)
    with _lock:
        h = _hists.get(k)
        if h is None:
            h = _hists[k] = _Hist()
        h.add(float(value))


def _percentile(sorted_vals, q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, int(round(q * (len(sorted_vals) - 1))))
    return sorted_vals[idx]


def _series_name(key: Tuple) -> str:
    name, labels = key[0], key[1:]
    if not labels:
        return name
    body = ",".join(f'{k}="{v}"' for k, v in labels)
    return f"{name}{{{body}}}"


def snapshot() -> Dict[str, Dict[str, Any]]:
    """Every series as a JSON-safe dict (histograms summarized)."""
    with _lock:
        counters = {_series_name(k): v for k, v in _counters.items()}
        gauges = {_series_name(k): v for k, v in _gauges.items()}
        hists = {}
        for k, h in _hists.items():
            vals = sorted(h.values)
            hists[_series_name(k)] = {
                "count": h.count,
                "sum": h.total,
                "p50": _percentile(vals, 0.50),
                "p95": _percentile(vals, 0.95),
                "p99": _percentile(vals, 0.99),
                "max": vals[-1] if vals else 0.0,
            }
    return {"counters": counters, "gauges": gauges, "histograms": hists}


def _escape_label_value(v: str) -> str:
    """Prometheus text-format label-value escaping: backslash, double
    quote, and newline must be escaped or the line breaks the scrape."""
    return (
        v.replace("\\", r"\\").replace('"', r"\"").replace("\n", r"\n")
    )


def _label_body(labels: Tuple) -> str:
    if not labels:
        return ""
    body = ",".join(
        f'{_sanitize(k)}="{_escape_label_value(v)}"' for k, v in labels
    )
    return "{" + body + "}"


def to_prometheus_text() -> str:
    """Prometheus text exposition of the current state.

    Emits one ``# HELP`` / ``# TYPE`` header per metric family (counter
    families carry the ``_total`` suffix; histogram summaries surface as
    per-stat gauge families) and escapes label values (backslash, quote,
    newline), so the output scrapes cleanly even when labels carry
    shapes, paths, or error strings.
    """
    with _lock:
        counters = dict(_counters)
        gauges = dict(_gauges)
        hists = {
            k: {"count": h.count, "sum": h.total,
                "values": sorted(h.values)}
            for k, h in _hists.items()
        }

    # family name -> (type, [(label_tuple, value)])
    families: Dict[str, Tuple[str, list]] = {}

    def add(family: str, kind: str, labels: Tuple, value) -> None:
        fam = families.setdefault(family, (kind, []))
        fam[1].append((labels, value))

    for (name, *labels), v in counters.items():
        add(_sanitize(name) + "_total", "counter", tuple(labels), v)
    for (name, *labels), v in gauges.items():
        add(_sanitize(name), "gauge", tuple(labels), v)
    for (name, *labels), h in hists.items():
        vals = h["values"]
        stats = {
            "count": h["count"], "sum": h["sum"],
            "p50": _percentile(vals, 0.50), "p95": _percentile(vals, 0.95),
            "p99": _percentile(vals, 0.99),
            "max": vals[-1] if vals else 0.0,
        }
        for stat, value in stats.items():
            add(f"{_sanitize(name)}_{stat}", "gauge", tuple(labels), value)

    lines = []
    for family in sorted(families):
        kind, rows = families[family]
        lines.append(
            f"# HELP {family} repro_torch.obs {kind} series {family}")
        lines.append(f"# TYPE {family} {kind}")
        for labels, value in sorted(rows, key=lambda r: r[0]):
            lines.append(f"{family}{_label_body(labels)} {value}")
    return "\n".join(lines) + ("\n" if lines else "")


def _sanitize(name: str) -> str:
    return name.replace(".", "_").replace("-", "_")


def reset() -> None:
    """Drop every recorded series (tests / fresh snapshots)."""
    with _lock:
        _counters.clear()
        _gauges.clear()
        _hists.clear()
