"""The traced run's reading of a ``torch.profiler`` trace.

The harness opens the profiler around the window itself, with the port's
spans on and mirrored into ``torch.profiler.record_function`` ranges
(``repro_torch.obs.trace.set_annotation_hook``); the port's own
``obs.profile`` stays off, since it synchronizes every call it times.

Every event is reduced to an :class:`Event` of one kind:

* ``range`` -- a host range (a mirrored span, or the harness's own
  ``lingambench.op`` around each timed operation);
* ``op``    -- a host operator (``aten::...``);
* ``launch``-- a CUDA runtime or driver API call (a kernel or graph
  launch, a copy, a synchronization);
* ``device``-- work on the card (a kernel, a copy, a memset).

A device event is attributed to the host ranges that were open when its
launch call was made: the call is found by the correlation id that CUPTI
gives both, or, failing that, by the host operator the profiler links to
the device event. Times are in seconds on the profiler's one clock.
"""

from __future__ import annotations

import bisect
import dataclasses
import re
from typing import Dict, List, Optional, Sequence, Tuple

OP_RANGE = "lingambench.op"
_LAUNCH_WORDS = ("LaunchKernel", "GraphLaunch", "LaunchCooperativeKernel")
_NAME_CHARS = 160


@dataclasses.dataclass(frozen=True)
class Event:
    kind: str          # "range" | "op" | "launch" | "device"
    name: str
    start: float       # seconds
    end: float
    corr: int = 0      # CUPTI correlation (launch, device) or op id (op)
    linked: int = 0    # device: the id of the host op it is linked to
    device_kind: str = ""  # device: "kernel", "gpu_memcpy", ...

    @property
    def seconds(self) -> float:
        return self.end - self.start


def is_launch_call(name: str) -> bool:
    """A launch API call: a kernel launch (runtime or driver, ``Ex`` and
    cooperative forms included) or a CUDA graph launch."""
    return any(w in name for w in _LAUNCH_WORDS)


_API = re.compile(r"^cu(da)?[A-Z]")


def _call(e, method, default=None):
    fn = getattr(e, method, None)
    try:
        return fn() if fn is not None else default
    except (RuntimeError, TypeError):
        return default


def from_kineto(events) -> List[Event]:
    """Normalize ``prof.profiler.kineto_results.events()``.

    Where the profiler names an event's activity (``activity_type``) that
    decides its kind. Older releases do not, and there a host event is a
    range if it is a user annotation, a launch if its name is a CUDA API
    call (``cuda...``, ``cu...``), an operator otherwise; a device event
    that mirrors a host range (same name) is not work on the card."""
    out, mirrors = [], []
    for e in events:
        act = _call(e, "activity_type")
        act = str(act) if act is not None else ""
        user = bool(_call(e, "is_user_annotation", False))
        dev = "CUDA" in str(e.device_type())
        start = e.start_ns() * 1e-9
        end = start + e.duration_ns() * 1e-9
        name = e.name()
        corr = int(_call(e, "correlation_id", 0) or 0)
        linked = int(_call(e, "linked_correlation_id", 0) or 0)
        if dev:
            if user or "annotation" in act:
                continue
            kind = act or ("gpu_memcpy" if name.startswith("Memcpy") else
                           "gpu_memset" if name.startswith("Memset") else
                           "kernel")
            mirrors.append(Event("device", name, start, end, corr, linked,
                                 kind))
            continue
        if act in ("cuda_runtime", "cuda_driver") or (
                not act and not user and _API.match(name)):
            kind = "launch"
        elif user or act == "user_annotation":
            kind = "range"
        elif act in ("cpu_op", ""):
            kind = "op"
        else:
            continue
        out.append(Event(kind, name, start, end, corr, linked))
    ranges = {e.name for e in out if e.kind == "range"}
    return out + [e for e in mirrors if e.name not in ranges]


def kinds(events: List[Event]) -> Dict[str, int]:
    """How many events of each kind (a diagnostic line of the traced
    run)."""
    out: Dict[str, int] = {}
    for e in events:
        key = e.kind if e.kind != "device" else f"device:{e.device_kind}"
        out[key] = out.get(key, 0) + 1
    return out


def union_seconds(intervals: Sequence[Tuple[float, float]], lo: float,
                  hi: float) -> float:
    """Length of the union of ``intervals`` inside [lo, hi]."""
    total, end = 0.0, lo
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def idle_gaps(intervals, lo, hi) -> List[Tuple[float, float]]:
    """The stretches of [lo, hi] that no interval covers."""
    gaps, end = [], lo
    for s, e in sorted(intervals):
        if s > end and end < hi:
            gaps.append((end, min(s, hi)))
        end = max(end, e)
    if end < hi:
        gaps.append((end, hi))
    return gaps


class _Ranges:
    """Host ranges of one name, merged into disjoint intervals, for fast
    "is t inside one" lookups."""

    def __init__(self, spans):
        merged: List[List[float]] = []
        for s, e in sorted(spans):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        self.spans = merged
        self.starts = [s for s, _ in merged]

    def contains(self, t: float) -> bool:
        i = bisect.bisect_right(self.starts, t) - 1
        return i >= 0 and self.spans[i][1] >= t


@dataclasses.dataclass
class TraceSummary:
    """What the per-layer readers take from one traced window."""

    window_s: float
    busy_s: float
    n_ops: int
    launch_calls: int
    device_s_by_range: Dict[str, float]
    kernels_with_launch: int
    kernels: int
    breakdown: Dict[str, list]
    unmatched: Dict[str, int] = dataclasses.field(default_factory=dict)

    def device_s_in(self, name: str) -> Optional[float]:
        """Device seconds of kernels launched inside ranges ``name``;
        None when the trace holds no such range."""
        return self.device_s_by_range.get(name)


def innermost_at(hosts: List[Event], times: Sequence[float]
                 ) -> List[Optional[Event]]:
    """For each time, the innermost (latest started) host event open at
    it, by one sweep over the events and the sorted times."""
    order = sorted(range(len(times)), key=lambda i: times[i])
    hosts = sorted(hosts, key=lambda e: e.start)
    out: List[Optional[Event]] = [None] * len(times)
    open_: List[Event] = []
    j = 0
    for i in order:
        t = times[i]
        while j < len(hosts) and hosts[j].start <= t:
            open_.append(hosts[j])
            j += 1
        open_ = [h for h in open_ if h.end >= t]
        out[i] = open_[-1] if open_ else None
    return out


def summarize(events: List[Event], range_names: Sequence[str] = ()
              ) -> Optional[TraceSummary]:
    """Reduce a normalized trace. The window runs from the first
    ``lingambench.op`` range's start to the last one's end; None when the
    trace holds no such range or no device event."""
    ops = [e for e in events if e.kind == "range" and e.name == OP_RANGE]
    device = [e for e in events if e.kind == "device"]
    if not ops or not device:
        return None
    lo = min(e.start for e in ops)
    hi = max(e.end for e in ops)
    device = [e for e in device if e.end > lo and e.start < hi]
    busy = union_seconds([(e.start, e.end) for e in device], lo, hi)
    launches = {e.corr: e for e in events
                if e.kind == "launch" and e.corr}
    host_ops = {e.corr: e for e in events
                if e.kind in ("op", "range") and e.corr}
    named = {n: _Ranges([(e.start, e.end) for e in events
                         if e.kind == "range" and e.name == n])
             for n in range_names}
    kernels = [e for e in device if e.device_kind in ("kernel", "")
               or "kernel" in e.device_kind]
    by_range = {n: 0.0 for n, r in named.items() if r.spans}
    matched, unmatched = 0, {}
    for k in kernels:
        call = launches.get(k.corr)
        if call is not None:
            matched += 1
            t = call.start
        else:
            key = k.name[:60]
            unmatched[key] = unmatched.get(key, 0) + 1
            if k.linked not in host_ops:
                continue
            t = host_ops[k.linked].start
        for n, r in named.items():
            if r.spans and r.contains(t):
                by_range[n] += k.seconds
    n_launch = sum(1 for e in events if e.kind == "launch"
                   and is_launch_call(e.name) and lo <= e.start <= hi)
    return TraceSummary(
        window_s=hi - lo, busy_s=busy, n_ops=len(ops), launch_calls=n_launch,
        device_s_by_range=by_range, kernels_with_launch=matched,
        kernels=len(kernels),
        breakdown=_breakdown(events, device, lo, hi),
        unmatched=dict(sorted(unmatched.items(), key=lambda kv: -kv[1])[:5]))


def _breakdown(events, device, lo, hi) -> Dict[str, list]:
    """The ten device operations that took most time, by name, and the
    ten host activities, by name, that the idle stretches fell in (the
    innermost host range open at a stretch's middle, with the innermost
    host operator open then), by their summed seconds."""
    per_op: Dict[str, float] = {}
    for e in device:
        name = e.name[:_NAME_CHARS]
        per_op[name] = per_op.get(name, 0.0) + e.seconds
    gaps = idle_gaps([(d.start, d.end) for d in device], lo, hi)
    mids = [0.5 * (s + e) for s, e in gaps]
    rs = innermost_at([e for e in events if e.kind == "range"], mids)
    os_ = innermost_at([e for e in events if e.kind == "op"], mids)
    per_gap: Dict[str, float] = {}
    for (s, e), r, o in zip(gaps, rs, os_):
        label = ((r.name if r else "host")
                 + (f" > {o.name}" if o else ""))[:_NAME_CHARS]
        per_gap[label] = per_gap.get(label, 0.0) + (e - s)
    top = sorted(per_op.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(per_gap.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, v] for k, v in top],
            "idle_gaps": [[k, v] for k, v in idle]}
