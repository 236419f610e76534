"""Compile-event accounting: which programs were built, how often, why
(the port's own copy of the reference's ``obs/compile_log.py``; standard
library only).

The port traces no jit programs. What it builds once and then reuses is
logged here, each event keyed by ``(op, shape, config_hash)``:

  * ``kernels.build`` -- an nvcc build of one CUDA source
    (``kernels/build.py``), once per source hash, with nvcc's seconds;
  * ``kernels.tune`` -- one timed launch-plan search
    (``kernels/tune/autotune.py``), once per tuning bucket;
  * ``sharded.fit`` -- one mesh-plan program shape (``core/sharded.py``),
    once per distinct (m, d, config) a process sets up.

So a build or search storm (an engine re-searching per request) is
*queryable*::

    from repro_torch.obs import compile_log

    before = compile_log.total("kernels.tune")
    engine.run(requests)
    assert compile_log.total("kernels.tune") == before  # warm table

The recorder is **always on** (unlike spans/metrics): its cost is a
counter update per build, search or new program shape, never per launch.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

_MAX_EVENTS = 4096

_lock = threading.Lock()
_counts: collections.Counter = collections.Counter()
_events: "collections.deque" = collections.deque(maxlen=_MAX_EVENTS)


def _shape_key(shape) -> Tuple[int, ...]:
    if shape is None:
        return ()
    try:
        return tuple(int(s) for s in shape)
    except TypeError:
        return (int(shape),)


def config_hash(config) -> str:
    """Short stable token for a (hashable) config object."""
    if config is None:
        return "-"
    try:
        h = hash(config)
    except TypeError:
        h = hash(repr(config))
    return f"{h & 0xFFFFFFFF:08x}"


def record(op: str, shape=None, config=None, **attrs) -> None:
    """Log one compile event for ``op`` (call from inside a trace body)."""
    key = (op, _shape_key(shape), config_hash(config))
    with _lock:
        _counts[key] += 1
        _events.append({
            "op": op,
            "shape": key[1],
            "config": key[2],
            "time": time.time(),
            **attrs,
        })
    from . import metrics

    metrics.inc("compiles", op=op)


def counts(op: Optional[str] = None) -> Dict[Tuple, int]:
    """Compile counts keyed by (op, shape, config_hash)."""
    with _lock:
        items = dict(_counts)
    if op is None:
        return items
    return {k: v for k, v in items.items() if k[0] == op}


def total(op: Optional[str] = None) -> int:
    """Total compiles, optionally restricted to one op."""
    return sum(counts(op).values())


def by_op() -> Dict[str, int]:
    """Compile counts aggregated per op name."""
    out: Dict[str, int] = {}
    for (op, _, _), n in counts().items():
        out[op] = out.get(op, 0) + n
    return out


def events(op: Optional[str] = None) -> List[dict]:
    """The recent compile events, oldest first (bounded ring)."""
    with _lock:
        evs = list(_events)
    return evs if op is None else [e for e in evs if e["op"] == op]


def snapshot() -> Dict[str, Any]:
    """JSON-safe summary: per-op totals + per-signature counts."""
    return {
        "by_op": by_op(),
        "by_signature": {
            f"{op}:{list(shape)}:{cfg}": n
            for (op, shape, cfg), n in sorted(counts().items())
        },
    }


def reset() -> None:
    with _lock:
        _counts.clear()
        _events.clear()
