"""Host-side tracing spans: nested, attributed, off by default (the port's
own copy of ``repro.obs.trace``).

A span times a region of *host* code::

    from repro_torch import obs

    with obs.span("serve.flush", due=3):
        ...

Spans nest by the host call stack (one stack per thread) and carry
arbitrary attributes. A span is pure host bookkeeping: it launches
nothing and reads nothing back from the card, so instrumented and
uninstrumented runs give bit-identical results. A span entered while
``torch.compile`` traces or while a CUDA graph is being captured
(:func:`capturing`) is tagged ``traced=True``: it times the trace or
the capture, not a run of the work.

Telemetry is **off by default**. Enable it with :func:`enable` or the
``REPRO_TORCH_OBS=1`` environment variable; when it is off, :func:`span`
returns a shared no-op context manager (one flag test, no allocation).

Completed root spans are kept in a bounded ring (newest last); render
them with :func:`format_tree`, or export them with
:func:`to_chrome_trace` / :func:`write_chrome_trace`. Each span's start
is also kept on the clock ``torch.profiler`` reports (Unix-epoch
nanoseconds, ``time.time_ns()``), so an exported file lays over the
profiler's trace of the same window.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Dict, List, Optional

import torch

from .ring import BoundedRing

_ENV_VAR = "REPRO_TORCH_OBS"

_ENABLED = os.environ.get(_ENV_VAR, "").strip().lower() not in (
    "", "0", "false", "off",
)

_MAX_ROOTS = 256

_lock = threading.Lock()
_roots = BoundedRing(_MAX_ROOTS)


class _Stack(threading.local):
    def __init__(self):
        self.spans: List["Span"] = []


_stack = _Stack()

# Span mirror: when set (by obs.profile.device_trace), every entered span
# calls it with the span name and enters the returned context manager (a
# torch.profiler.record_function), so host spans show on the device
# timeline under the same names. None (the default) costs one read.
_annotation_hook = None


def set_annotation_hook(fn) -> None:
    """Install/clear (``None``) the span->device-annotation mirror."""
    global _annotation_hook
    _annotation_hook = fn


def enable(on: bool = True) -> None:
    """Turn telemetry on (spans + metrics). Off by default."""
    global _ENABLED
    _ENABLED = bool(on)


def disable() -> None:
    enable(False)


def enabled() -> bool:
    return _ENABLED


def capturing() -> bool:
    """True while ``torch.compile`` traces or a CUDA graph is being
    captured on the current stream: work issued now is recorded into a
    program, not run. The kernel dispatcher's search guard and the span
    ``traced`` tag both read this one predicate."""
    if torch.compiler.is_compiling():
        return True
    return (torch.cuda.is_available()
            and torch.cuda.is_current_stream_capturing())


class Span:
    """One timed host region. Use via :func:`span`, not directly."""

    __slots__ = (
        "name", "attrs", "traced", "t0", "t0_ns", "duration_s", "children",
        "_ann",
    )

    def __init__(self, name: str, attrs: Dict[str, Any]):
        self.name = name
        self.attrs = attrs
        self.traced = False
        self.t0 = 0.0       # time.perf_counter(): the duration's clock
        self.t0_ns = 0      # time.time_ns(): the profiler's clock
        self.duration_s = 0.0
        self.children: List["Span"] = []
        self._ann = None

    def set(self, **attrs) -> "Span":
        """Attach/overwrite attributes mid-span."""
        self.attrs.update(attrs)
        return self

    def __enter__(self) -> "Span":
        self.traced = capturing()
        if _annotation_hook is not None:
            self._ann = _annotation_hook(self.name)
            self._ann.__enter__()
        _stack.spans.append(self)
        self.t0_ns = time.time_ns()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.duration_s = time.perf_counter() - self.t0
        if self._ann is not None:
            try:
                self._ann.__exit__(exc_type, exc, tb)
            finally:
                self._ann = None
        if exc_type is not None:
            self.attrs["error"] = exc_type.__name__
        stack = _stack.spans
        if stack and stack[-1] is self:
            stack.pop()
        if stack:
            stack[-1].children.append(self)
        else:
            with _lock:
                _roots.append(self)
        from . import metrics

        metrics.observe(f"span.{self.name}_s", self.duration_s)


class _NoopSpan:
    """Shared disabled-telemetry span: no allocation, no timing."""

    __slots__ = ()

    def set(self, **attrs) -> "_NoopSpan":
        return self

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        return None


_NOOP = _NoopSpan()


def span(name: str, **attrs):
    """A timed host-side span (no-op unless telemetry is enabled)."""
    if not _ENABLED:
        return _NOOP
    return Span(name, attrs)


def roots(last: Optional[int] = None) -> List[Span]:
    """Completed root spans, oldest first (bounded ring)."""
    with _lock:
        out = list(_roots)
    return out if last is None else out[-last:]


def reset() -> None:
    """Drop all recorded spans (the current thread's open stack too)."""
    with _lock:
        _roots.clear()
    _stack.spans.clear()


def _fmt_attrs(attrs: Dict[str, Any]) -> str:
    if not attrs:
        return ""
    body = ", ".join(f"{k}={v}" for k, v in attrs.items())
    return "  {" + body + "}"


def _fmt_span(s: Span, indent: int, lines: List[str]) -> None:
    ms = s.duration_s * 1e3
    tag = "  [trace]" if s.traced else ""
    lines.append(
        f"{'  ' * indent}{s.name}  {ms:.2f}ms{tag}{_fmt_attrs(s.attrs)}"
    )
    for c in s.children:
        _fmt_span(c, indent + 1, lines)


def format_tree(last: Optional[int] = None) -> str:
    """ASCII rendering of the recorded span trees."""
    lines: List[str] = []
    for s in roots(last):
        _fmt_span(s, 0, lines)
    return "\n".join(lines) if lines else "(no spans recorded)"


def to_chrome_trace(last: Optional[int] = None, *,
                    since_ns: Optional[int] = None) -> Dict[str, Any]:
    """Finished span trees as Chrome/Perfetto trace-event JSON.

    Every span becomes one complete ("ph": "X") event with microsecond
    timestamps rebased to the earliest recorded root, so the file drops
    straight into ``chrome://tracing`` / https://ui.perfetto.dev. As in
    ``torch.profiler``'s export, ``baseTimeNanoseconds`` is that root's
    start on the Unix-epoch clock: ``ts * 1e3 + baseTimeNanoseconds`` is
    a span's start in the profiler's nanoseconds. Span attributes land
    in ``args`` (stringified); spans entered while capturing keep their
    ``traced`` tag as the event category (``"capture"``). ``since_ns``
    keeps only the roots that started at or after it.
    """
    spans = roots(last)
    if since_ns is not None:
        spans = [s for s in spans if s.t0_ns >= since_ns]
    base = min((s.t0_ns for s in spans), default=0)
    events: List[Dict[str, Any]] = []

    def emit(s: Span) -> None:
        events.append({
            "name": s.name,
            "cat": "capture" if s.traced else "host",
            "ph": "X",
            "ts": (s.t0_ns - base) / 1e3,
            "dur": s.duration_s * 1e6,
            "pid": 0,
            "tid": 0,
            "args": {k: str(v) for k, v in s.attrs.items()},
        })
        for c in s.children:
            emit(c)

    for s in spans:
        emit(s)
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "baseTimeNanoseconds": base}


def write_chrome_trace(path: str, last: Optional[int] = None, *,
                       since_ns: Optional[int] = None) -> str:
    """Serialize :func:`to_chrome_trace` to ``path``; returns the path."""
    import json

    with open(path, "w") as f:
        json.dump(to_chrome_trace(last, since_ns=since_ns), f, indent=1)
    return path
