"""Persistent tuning table: committed defaults + a local overlay.

The table maps **versioned, shape-bucketed keys** to launch plans:

    v1/<device_kind>/<op>/<backend>/<dtype>/<shape-bucket>

``device_kind`` is ``torch.cuda.get_device_name()`` of the card the
launch runs on, or ``"cpu"``, so plans measured on one card never leak
onto another (an H100 SXM and an H100 PCIe report different names, and a
name missing from the table falls back to the heuristic). Shapes are
bucketed to the next power of two per axis, the batch of a batched
launch included: one measured plan covers the whole bucket, so serving
and streaming sessions hit tuned plans without a first-request search.

Two layers merge at load time:

  * **defaults** -- ``default_plans.json`` next to this module, committed
    to the repository and filled from measurements on the card
    (``python3 -m repro_torch.kernels.tune.autotune``);
  * **overlay** -- a local JSON file: ``$REPRO_TORCH_TUNE_CACHE`` or
    ``build/tune/tune_plans.json`` at the repository root (ignored by
    git). ``record()`` writes here, and overlay entries shadow defaults
    with the same key. The variable is the port's own: the JAX package
    reads ``REPRO_TUNE_CACHE``, and neither package reads the other's
    plans.

``TuneTable(offline=True)`` never touches the filesystem and never
returns a tuned entry: ``dispatch`` then degrades to the heuristic
deterministically (the ``FitConfig(tune="off")`` path).
"""

from __future__ import annotations

import json
import os
import threading
from pathlib import Path
from typing import Dict, Optional, Tuple

SCHEMA_VERSION = 1

_DEFAULT_PATH = os.path.join(os.path.dirname(__file__), "default_plans.json")
_OVERLAY_ENV = "REPRO_TORCH_TUNE_CACHE"
_OVERLAY_DEFAULT = (Path(__file__).resolve().parents[4] / "build" / "tune"
                    / "tune_plans.json")

_lock = threading.Lock()
_table: Optional["TuneTable"] = None


def overlay_path() -> str:
    """Local overlay location (the environment variable wins)."""
    return os.environ.get(_OVERLAY_ENV) or str(_OVERLAY_DEFAULT)


def bucket_pow2(n: int, lo: int = 8) -> int:
    """Next power of two >= n (floored at ``lo``): one tuned plan per
    bucket keeps the table bounded as shapes drift."""
    b = lo
    while b < n:
        b *= 2
    return b


def shape_bucket(op: str, shape: Tuple[int, ...], batch: int = 1) -> str:
    """Canonical bucket token for an op's dispatch shape.

    2-tuples are (m, d) sample-major; 3-tuples are (tile, d, m). ``batch``
    is the leading batch axis of a batched launch (1 for a single one).
    """
    b = f".b{bucket_pow2(batch, lo=1)}"
    if len(shape) == 2:
        m, d = shape
        return f"d{bucket_pow2(d)}.m{bucket_pow2(m, lo=64)}{b}"
    if len(shape) == 3:
        tile, d, m = shape
        return (f"t{bucket_pow2(tile)}.d{bucket_pow2(d)}."
                f"m{bucket_pow2(m, lo=64)}{b}")
    raise ValueError(f"unsupported dispatch shape for {op!r}: {shape}")


def plan_key(
    device_kind: str, op: str, backend: str, dtype: str, bucket: str
) -> str:
    """Versioned table key. The backend is part of the key so plans of
    two backends tuned at the same bucket never collide."""
    kind = "-".join(str(device_kind).lower().split())
    return f"v{SCHEMA_VERSION}/{kind}/{op}/{backend}/{dtype}/{bucket}"


def _load_json(path: str) -> Dict[str, dict]:
    try:
        with open(path) as f:
            payload = json.load(f)
    except (OSError, ValueError):
        return {}
    if payload.get("version") != SCHEMA_VERSION:
        return {}
    entries = payload.get("entries", {})
    return entries if isinstance(entries, dict) else {}


class TuneTable:
    """Merged defaults + overlay view of the persistent tuning table."""

    def __init__(
        self,
        default_path: Optional[str] = None,
        overlay_path_: Optional[str] = None,
        *,
        offline: bool = False,
    ):
        self.offline = offline
        self.default_path = (
            _DEFAULT_PATH if default_path is None else default_path
        )
        self.overlay_path = (
            overlay_path() if overlay_path_ is None else overlay_path_
        )
        self._defaults: Dict[str, dict] = {}
        self._overlay: Dict[str, dict] = {}
        if not offline:
            self._defaults = _load_json(self.default_path)
            self._overlay = _load_json(self.overlay_path)

    def lookup(self, key: str) -> Optional[dict]:
        """Overlay entry if present, else the committed default."""
        if self.offline:
            return None
        return self._overlay.get(key) or self._defaults.get(key)

    def record(self, key: str, entry: dict, *, persist: bool = True) -> None:
        """Install a measured plan (overlay layer; optionally on disk)."""
        if self.offline:
            raise RuntimeError("cannot record into an offline TuneTable")
        self._overlay[key] = dict(entry)
        if persist:
            self.save_overlay()

    def save_overlay(self) -> None:
        os.makedirs(os.path.dirname(self.overlay_path) or ".", exist_ok=True)
        tmp = self.overlay_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(
                {"version": SCHEMA_VERSION, "entries": self._overlay},
                f,
                indent=1,
                sort_keys=True,
            )
        os.replace(tmp, self.overlay_path)

    def __len__(self) -> int:
        merged = {**self._defaults, **self._overlay}
        return len(merged)


def get_table() -> TuneTable:
    """Process-wide table singleton (loaded once; ``reset_table`` after
    external writes, e.g. in tests)."""
    global _table
    with _lock:
        if _table is None:
            _table = TuneTable()
        return _table


def reset_table() -> None:
    global _table
    with _lock:
        _table = None
