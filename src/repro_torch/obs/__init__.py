"""Telemetry for the PyTorch/CUDA port (the reference's ``repro.obs``
surface).

  * :mod:`repro_torch.obs.trace` -- nested host-side spans
    (``with obs.span("fit.local", d=d): ...``). Off by default; enable
    with :func:`enable` or ``REPRO_TORCH_OBS=1``. A span launches nothing
    and reads nothing back, so results are bit-identical with telemetry
    on and off; spans entered while ``torch.compile`` traces or a CUDA
    graph is captured are tagged ``traced``.
  * :mod:`repro_torch.obs.metrics` -- process-local counters / gauges /
    histograms with p50/p95/p99 summaries, exported via
    :func:`repro_torch.obs.metrics.snapshot` or
    :func:`repro_torch.obs.metrics.to_prometheus_text`.
  * :mod:`repro_torch.obs.compile_log` -- always-on accounting of what
    the port builds once: nvcc kernel builds, tuning searches and
    mesh-plan program shapes, keyed by ``(op, shape, config_hash)``.
  * :mod:`repro_torch.obs.profile` -- performance accounting on top of
    the other three: analytic operation/byte counts, CUDA-event timings
    and memory watermarks per ``(op, shape, config)``, roofline
    utilization against the card's peaks, and ``device_trace()`` for
    ``torch.profiler`` traces with the spans on them. Off by default;
    enable with :func:`repro_torch.obs.profile.enable` or
    ``REPRO_TORCH_OBS_PROFILE=1``.

``repro_torch.analysis.regress`` compares fresh benchmark runs against
the committed ``BENCH_torch_*.json`` baselines, which record the
hardware they ran on (:func:`provenance`).
"""

from __future__ import annotations

import time
from typing import Any, Dict

from . import compile_log, metrics, profile, ring, trace
from .ring import BoundedRing  # noqa: F401
from .trace import (  # noqa: F401  (re-exported convenience surface)
    enable,
    disable,
    enabled,
    format_tree,
    reset,
    roots,
    span,
    to_chrome_trace,
    write_chrome_trace,
)

__all__ = [
    "BoundedRing",
    "compile_log",
    "metrics",
    "profile",
    "ring",
    "trace",
    "enable",
    "disable",
    "enabled",
    "format_tree",
    "provenance",
    "reset",
    "reset_all",
    "roots",
    "span",
    "to_chrome_trace",
    "write_chrome_trace",
]


def reset_all() -> None:
    """Clear spans, metrics, the compile log, and cost records."""
    trace.reset()
    metrics.reset()
    compile_log.reset()
    profile.reset()


def provenance(repo_root: str = ".") -> Dict[str, Any]:
    """What produced this process's numbers: torch and CUDA versions, the
    card's name and power limit (``nvidia-smi --query-gpu=name,
    power.limit``), the git sha."""
    import platform
    import subprocess

    import torch

    out: Dict[str, Any] = {
        "timestamp": time.strftime("%Y-%m-%dT%H:%M:%S"),
        "python": platform.python_version(),
        "hostname": platform.node(),
        "machine": platform.machine(),
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
    }
    if torch.cuda.is_available():
        out["platform"] = "gpu"
        out["device_kind"] = torch.cuda.get_device_name(0)
        out["n_devices"] = torch.cuda.device_count()
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        )
        out["nvidia_smi"] = smi.stdout.strip().splitlines()[0]
    else:
        out["platform"] = "cpu"
        out["device_kind"] = "cpu"
        out["n_devices"] = 0
    try:
        sha = subprocess.run(
            ["git", "rev-parse", "HEAD"],
            cwd=repo_root, capture_output=True, text=True, timeout=5,
        )
        out["git_sha"] = sha.stdout.strip() if sha.returncode == 0 \
            else "unknown"
    except OSError:  # no git on the machine
        out["git_sha"] = "unknown"
    return out
