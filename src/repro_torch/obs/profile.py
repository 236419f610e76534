"""Performance accounting: cost records, memory watermarks, roofline
utilization, and device traces with the host spans on them (the port of
the reference's ``obs/profile.py``).

  * **Cost records** -- :func:`call` routes an entry point through the
    profiler: once per ``(op, shape, config-hash)`` signature (the key
    scheme of :mod:`repro_torch.obs.compile_log`) it records the
    analytic operation and byte counts of :func:`analytic_cost`, then
    times every call (CUDA events on the card, the host clock on the
    CPU), keeps the call's device-memory high-water mark
    (``torch.cuda.max_memory_allocated``) and the bytes the mesh plan's
    collectives moved during it (:func:`collective_bytes`).
  * **Roofline utilization** -- :func:`device_peaks` gives the ceilings
    of the card the process runs on; :func:`utilization` turns
    (operations, bytes, seconds) into achieved rates and the share of
    the roofline. The moment kernels are bound by the special-function
    units (three MUFU operations a (pair, sample) term: ``ex2`` and
    ``lg2`` for log cosh, ``ex2`` for exp(-u^2/2)), so a CUDA entry's
    ``flops_per_s`` is the SFU rate, SMs x 16 a clock x the SM clock,
    not a tensor-core rate; ``fp32_flops_per_s`` is the CUDA-core rate
    that the pruning's matrix work is held to.
  * **Device traces** -- :func:`device_trace` runs ``torch.profiler``
    and mirrors every host span into a ``record_function`` of the same
    name, so the span tree and the kernels line up in one Chrome trace.

Profiling is **off by default**: enable it with :func:`enable` or
``REPRO_TORCH_OBS_PROFILE=1``. Off, :func:`call` is ``fn(*args,
**kwargs)`` after one flag test: no timing, no synchronization, no
records. On, every call synchronizes the card.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

from . import compile_log, metrics, trace

_ENV_VAR = "REPRO_TORCH_OBS_PROFILE"
_PEAKS_ENV = "REPRO_TORCH_PEAKS"

_ENABLED = os.environ.get(_ENV_VAR, "").strip().lower() not in (
    "", "0", "false", "off",
)

_lock = threading.Lock()
_records: Dict[Tuple, "CostRecord"] = {}
# Bytes each kind of collective moved (the mesh plan's, on this rank)
# while profiling was on: {"all-reduce": n, "all-gather": n}.
_collectives: Dict[str, int] = {}


def enable(on: bool = True) -> None:
    """Turn performance profiling on (cost records + timed calls)."""
    global _ENABLED
    _ENABLED = bool(on)


def disable() -> None:
    enable(False)


def enabled() -> bool:
    return _ENABLED


# ---------------------------------------------------------------------------
# Device peaks (roofline ceilings)
# ---------------------------------------------------------------------------

#: Special-function (MUFU) operations an SM issues a clock on Hopper and
#: Ampere: 16 (four SM sub-partitions, four a clock each).
SFU_OPS_PER_CLOCK_PER_SM = 16
#: fp32 FMA lanes an SM has on Hopper (128), two flops each.
FP32_FLOPS_PER_CLOCK_PER_SM = 2 * 128
#: The moment kernels' special-function operations per (pair, sample)
#: term: ex2 for exp(-2|u|), lg2 for log1p, ex2 for exp(-u^2/2).
SFU_OPS_PER_TERM = 3


@dataclasses.dataclass(frozen=True)
class DevicePeaks:
    """Peak rates of one device: the roofline ceilings.

    ``flops_per_s`` is the rate of the operations :func:`analytic_cost`
    counts for the moment kernels: on a CUDA card the special-function
    rate. ``hbm_bw`` is the main-memory rate in bytes/s and ``ici_bw``
    the rate of one interconnect link (NVLink, per direction), used for
    collective terms. ``fp32_flops_per_s`` is the fp32 CUDA-core rate of
    the dense float work (0 means the same as ``flops_per_s``).
    """

    name: str
    flops_per_s: float
    hbm_bw: float
    ici_bw: float
    fp32_flops_per_s: float = 0.0

    def rate(self, unit: str) -> float:
        """The ceiling of operations of kind ``unit`` ("sfu" or "fp32")."""
        if unit == "fp32" and self.fp32_flops_per_s:
            return self.fp32_flops_per_s
        return self.flops_per_s


def cuda_peaks(name: str, sms: int, clock_mhz: float, hbm_bw: float,
               ici_bw: float) -> DevicePeaks:
    """The ceilings of a card with ``sms`` SMs at ``clock_mhz``."""
    clock = clock_mhz * 1e6
    return DevicePeaks(
        name=name, flops_per_s=sms * SFU_OPS_PER_CLOCK_PER_SM * clock,
        hbm_bw=hbm_bw, ici_bw=ici_bw,
        fp32_flops_per_s=sms * FP32_FLOPS_PER_CLOCK_PER_SM * clock)


#: CUDA cards by a substring of their name (lower case), first match
#: wins: (entry name, SMs, max SM clock in MHz, HBM bytes/s, NVLink bytes/s
#: a direction), nominal values. The H100 SXM: 132 SMs at 1980 MHz,
#: HBM3 at 3.35 TB/s, NVLink 450 GB/s a direction.
CUDA_CARDS: Tuple[Tuple[str, Tuple[str, int, float, float, float]], ...] = (
    ("h100", ("gpu-h100", 132, 1980.0, 3.35e12, 450e9)),
    ("a100", ("gpu-a100", 108, 1410.0, 2.039e12, 300e9)),
    ("gpu", ("gpu-generic", 100, 1500.0, 1e12, 100e9)),
)

#: The ceilings by device-name substring, first match wins. The cpu
#: entry is a round placeholder; override any field with
#: ``REPRO_TORCH_PEAKS``.
PEAKS_TABLE: Tuple[Tuple[str, DevicePeaks], ...] = tuple(
    (token, cuda_peaks(*card)) for token, card in CUDA_CARDS
) + (("cpu", DevicePeaks("cpu-generic", 100e9, 20e9, 10e9)),)

_FALLBACK_PEAKS = DevicePeaks("unknown", 100e9, 20e9, 10e9)


@functools.lru_cache(maxsize=None)
def _card(index: int) -> Tuple[str, int, float]:
    """(name, SMs, max SM clock in MHz) of card ``index``: the clock as
    ``nvidia-smi`` reports it."""
    import subprocess

    clock = subprocess.run(
        ["nvidia-smi", f"--id={index}", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    props = torch.cuda.get_device_properties(index)
    return (torch.cuda.get_device_name(index), props.multi_processor_count,
            float(clock))


def device_peaks(kind: Optional[str] = None, *, sms: Optional[int] = None,
                 clock_mhz: Optional[float] = None) -> DevicePeaks:
    """Roofline ceilings for ``kind`` (default: the process's device).

    With no ``kind``, on a card, the SM count comes from
    ``torch.cuda.get_device_properties`` and the clock from
    ``nvidia-smi``; without a card, the ``cpu`` entry. ``sms`` and
    ``clock_mhz`` replace a CUDA entry's nominal ones.
    ``REPRO_TORCH_PEAKS`` overrides single fields on top of the result,
    e.g. ``REPRO_TORCH_PEAKS="flops=3.2e12,hbm=80e9"`` (keys:
    name/flops/hbm/ici/fp32).
    """
    if kind is None:
        if torch.cuda.is_available():
            kind, card_sms, card_clock = _card(torch.cuda.current_device())
            sms = card_sms if sms is None else sms
            clock_mhz = card_clock if clock_mhz is None else clock_mhz
        else:
            kind = "cpu"
    low = str(kind).lower()
    base = _FALLBACK_PEAKS
    for token, peaks in PEAKS_TABLE:
        if token in low:
            base = peaks
            card = dict(CUDA_CARDS).get(token)
            if card is not None and (sms is not None
                                     or clock_mhz is not None):
                name, n_sm, clock, hbm, ici = card
                base = cuda_peaks(name, n_sm if sms is None else sms,
                                  clock if clock_mhz is None else clock_mhz,
                                  hbm, ici)
            break
    env = os.environ.get(_PEAKS_ENV, "").strip()
    if not env:
        return base
    fields = {"name": base.name, "flops": base.flops_per_s,
              "hbm": base.hbm_bw, "ici": base.ici_bw,
              "fp32": base.fp32_flops_per_s}
    for part in env.split(","):
        if "=" not in part:
            continue
        k, v = part.split("=", 1)
        k = k.strip().lower()
        if k == "name":
            fields["name"] = v.strip()
        elif k in fields:
            try:
                fields[k] = float(v)
            except ValueError:
                pass
    return DevicePeaks(
        name=str(fields["name"]), flops_per_s=float(fields["flops"]),
        hbm_bw=float(fields["hbm"]), ici_bw=float(fields["ici"]),
        fp32_flops_per_s=float(fields["fp32"]),
    )


def roofline_bound(flops: float, bytes_accessed: float,
                   peaks: Optional[DevicePeaks] = None,
                   unit: str = "sfu") -> Dict[str, Any]:
    """The least time ``peaks`` allows for the work: the larger of
    operations over the ``unit`` ceiling and bytes over the memory rate.
    Returns {"bound_s", "compute_s", "memory_s", "bound"}."""
    peaks = peaks or device_peaks()
    t_compute = flops / peaks.rate(unit)
    t_memory = bytes_accessed / peaks.hbm_bw
    return {
        "bound_s": max(t_compute, t_memory),
        "compute_s": t_compute,
        "memory_s": t_memory,
        "bound": "compute" if t_compute >= t_memory else "memory",
    }


def utilization(
    flops: float, bytes_accessed: float, seconds: float,
    peaks: Optional[DevicePeaks] = None, unit: str = "sfu",
) -> Dict[str, Any]:
    """Achieved rates and roofline fraction of one timed execution.

    ``roofline_frac`` is (roofline-bound seconds) / (measured seconds),
    the bound being :func:`roofline_bound`'s: 1.0 means the work ran at
    the ceiling its intensity allows. ``unit`` names the kind of the
    operations: "sfu" (the moment kernels') or "fp32".
    """
    peaks = peaks or device_peaks()
    s = max(float(seconds), 1e-12)
    b = roofline_bound(flops, bytes_accessed, peaks, unit)
    return {
        "gflops_per_s": flops / s / 1e9,
        "gbytes_per_s": bytes_accessed / s / 1e9,
        "intensity": flops / max(bytes_accessed, 1.0),
        "roofline_frac": b["bound_s"] / s,
        "bound": b["bound"],
        "peaks": peaks.name,
    }


# ---------------------------------------------------------------------------
# Analytic cost model
# ---------------------------------------------------------------------------

#: Ops whose shape is (m, d), or (b, m, d) for a batch of fits, and whose
#: config picks the plan: their modelled work is the ordering's pairwise
#: moments.
FIT_OPS = ("core.fit", "sharded.fit", "report.ordering", "batched.fit_many",
           "batched.fit_many_from_stats", "batched.bootstrap_fits")


def _moment_cost(rows: int, d: int, m: int, *, batch: int = 1,
                 x_bytes: float = None) -> Tuple[float, float]:
    """(SFU operations, bytes) of the moment sums of a (rows, d) pair tile
    over m samples: 3 operations a (pair, sample) term; x read once (4
    bytes a value unless ``x_bytes`` says otherwise), the correlation
    rows read once and both (rows, d) outputs written once."""
    ops = float(SFU_OPS_PER_TERM) * rows * d * m * batch
    x_bytes = 4.0 * m * d if x_bytes is None else x_bytes
    return ops, batch * (x_bytes + 4.0 * 3 * rows * d)


def analytic_cost(op: str, shape, *, config=None, batch: int = 1,
                  itemsize: int = 4) -> Optional[Dict[str, Any]]:
    """Modelled operations and bytes of one op at one shape; None for an
    op without a model.

    The count is the same whatever implements the op (the CUDA kernel or
    its plain version), so both read one roofline:

      * ``pairwise_moments`` / ``pairwise_moment_sums_chunked`` (m, d):
        kernel B1 (and B2 over slabs): 3 SFU operations for each of the
        d^2 m (pair, sample) terms; x_std (m, d) and C (d, d) read once,
        two (d, d) outputs written once;
      * ``pairwise_moment_sums_rows`` (tile, d, m): kernel B2 on a row
        tile; ``fused_moment_sums`` (tile, d, m): kernel B3, X read in
        ``itemsize`` bytes a value plus its (d,) mean and scale;
      * the fit ops of ``FIT_OPS`` at (m, d), or (b, m, d) for a batch,
        with a fit ``config``: the ordering's moment work at the widths
        its steps run at (``core.ordering.order_schedule``: one step at
        each width d .. 2 on the local plan, the configured schedule on
        the mesh plan);
      * ``report.pruning`` (m, d): the OLS pruning's fp32 flops (the
        covariance, 2 m d^2, and d masked solves, 2/3 d^3 each);
      * ``report.solve`` (m, d): the residual diagnostics' fp32 flops.

    ``batch`` multiplies the kernels' work (a batched launch). Returns
    {"flops", "bytes", "intensity", "unit"}, ``unit`` being "sfu" or
    "fp32" (the ceiling :func:`utilization` holds it to).
    """
    try:
        dims = tuple(int(s) for s in shape)
    except TypeError:
        return None
    unit = "sfu"
    if op in ("pairwise_moments", "pairwise_moment_sums_chunked") \
            and len(dims) in (2, 3):
        m, d = dims[-2:]
        batch *= dims[0] if len(dims) == 3 else 1
        flops, nbytes = _moment_cost(d, d, m, batch=batch)
    elif op == "pairwise_moment_sums_rows" and len(dims) == 3:
        tile, d, m = dims
        flops, nbytes = _moment_cost(tile, d, m, batch=batch)
    elif op == "fused_moment_sums" and len(dims) == 3:
        tile, d, m = dims
        flops, nbytes = _moment_cost(
            tile, d, m, batch=batch, x_bytes=itemsize * m * d + 4.0 * 2 * d)
    elif op in FIT_OPS and len(dims) in (2, 3) and config is not None:
        from repro_torch.core.ordering import order_schedule

        m, d = dims[-2:]
        batch *= dims[0] if len(dims) == 3 else 1
        flops = nbytes = 0.0
        for width, n_steps in order_schedule(d, config):
            f, b = _moment_cost(width, width, m, batch=batch)
            flops += n_steps * f
            nbytes += n_steps * b
    elif op == "report.pruning" and len(dims) == 2:
        m, d = dims
        unit = "fp32"
        flops = 2.0 * m * d * d + d * (2.0 / 3.0) * d ** 3
        nbytes = 4.0 * (m * d + d * d)
    elif op == "report.solve" and len(dims) == 2:
        m, d = dims
        unit = "fp32"
        flops = 2.0 * m * d * d + 3.0 * m * d
        nbytes = 4.0 * (m * d + d * d + d)
    else:
        return None
    return {
        "flops": flops,
        "bytes": nbytes,
        "intensity": flops / max(nbytes, 1.0),
        "unit": unit,
    }


# ---------------------------------------------------------------------------
# Collective accounting (the mesh plan's own collectives)
# ---------------------------------------------------------------------------


def note_collective(kind: str, nbytes: int) -> None:
    """Count ``nbytes`` (this rank's operand bytes) moved by one collective
    of ``kind`` ("all-reduce", "all-gather"). Called by the mesh plan's
    collective helper (``core.sharded``); one flag test when off."""
    if not _ENABLED:
        return
    with _lock:
        _collectives[kind] = _collectives.get(kind, 0) + int(nbytes)


def collective_bytes() -> Dict[str, int]:
    """Operand bytes per collective kind that the mesh plan moved on this
    rank while profiling was on (since the last :func:`reset`)."""
    with _lock:
        return dict(_collectives)


# ---------------------------------------------------------------------------
# Cost store
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CostRecord:
    """One signature's modelled costs and execution statistics."""

    op: str
    shape: Tuple[int, ...]
    config: str                      # compile_log.config_hash token
    flops: float = 0.0               # per execution, analytic
    bytes_accessed: float = 0.0
    unit: str = "sfu"                # the ceiling flops are held to
    arg_bytes: int = 0               # tensor arguments
    out_bytes: int = 0               # tensor results
    temp_bytes: int = 0              # the call's device high-water mark
                                     # above its starting allocation
    collectives: Dict[str, int] = dataclasses.field(default_factory=dict)
    source: str = "analytic"         # "analytic" | "unavailable"
    calls: int = 0
    total_s: float = 0.0
    best_s: float = math.inf

    def row(self, peaks: Optional[DevicePeaks] = None) -> Dict[str, Any]:
        """JSON-safe row with utilization derived at the best latency."""
        out: Dict[str, Any] = {
            "op": self.op,
            "shape": list(self.shape),
            "config": self.config,
            "source": self.source,
            "flops": self.flops,
            "bytes": self.bytes_accessed,
            "unit": self.unit,
            "arg_bytes": self.arg_bytes,
            "out_bytes": self.out_bytes,
            "temp_bytes": self.temp_bytes,
            "collective_bytes": dict(self.collectives),
            "calls": self.calls,
            "total_s": self.total_s,
            "best_s": self.best_s if self.calls else 0.0,
        }
        if self.calls and (self.flops or self.bytes_accessed):
            out.update(utilization(
                self.flops, self.bytes_accessed, self.best_s, peaks,
                self.unit))
        return out


def _key(op: str, shape, config) -> Tuple:
    # The compile_log key scheme: cost rows join compile events.
    return (op, compile_log._shape_key(shape), compile_log.config_hash(config))


def _tensor_bytes(obj) -> int:
    """Bytes of the tensors in ``obj`` (a tensor, or a dataclass, tuple,
    list or dict holding tensors)."""
    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return sum(_tensor_bytes(getattr(obj, f.name))
                   for f in dataclasses.fields(obj))
    if isinstance(obj, (tuple, list)):
        return sum(_tensor_bytes(o) for o in obj)
    if isinstance(obj, dict):
        return sum(_tensor_bytes(o) for o in obj.values())
    return 0


def _device_of(args) -> torch.device:
    for a in args:
        if isinstance(a, torch.Tensor):
            return a.device
    return torch.device("cpu")


def _new_record(op: str, shape, config, args) -> CostRecord:
    rec = CostRecord(op=op, shape=compile_log._shape_key(shape),
                     config=compile_log.config_hash(config),
                     arg_bytes=_tensor_bytes(args))
    cost = analytic_cost(op, shape, config=config)
    if cost is None:
        rec.source = "unavailable"
    else:
        rec.flops, rec.bytes_accessed = cost["flops"], cost["bytes"]
        rec.unit = cost["unit"]
    return rec


def call(fn, *args, op: str, shape=None, config=None, **kwargs):
    """Route one entry-point call through the profiler.

    Off (the default), this is ``fn(*args, **kwargs)``. On, the first
    call per ``(op, shape, config-hash)`` creates the signature's
    :class:`CostRecord` from :func:`analytic_cost`, and every call is
    timed to its end (CUDA events and a synchronize on the card, the
    host clock on the CPU), its device-memory high-water mark and its
    collective bytes noted, and folded into the record and the
    ``profile.*`` metrics. While ``torch.compile`` traces or a CUDA graph
    is captured, calls pass straight through.
    """
    if not _ENABLED or trace.capturing():
        return fn(*args, **kwargs)
    key = _key(op, shape, config)
    with _lock:
        rec = _records.get(key)
    if rec is None:
        rec = _new_record(op, shape, config, args)
        with _lock:
            rec = _records.setdefault(key, rec)
    device = _device_of(args)
    coll0 = collective_bytes()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        base = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = fn(*args, **kwargs)
        e1.record()
        e1.synchronize()
        dt = e0.elapsed_time(e1) * 1e-3
        temp = torch.cuda.max_memory_allocated(device) - base
    else:
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        dt = time.perf_counter() - t0
        temp = 0
    coll1 = collective_bytes()
    with _lock:
        rec.calls += 1
        rec.total_s += dt
        rec.best_s = min(rec.best_s, dt)
        rec.out_bytes = _tensor_bytes(out)
        rec.temp_bytes = max(rec.temp_bytes, int(temp))
        rec.collectives = {k: v - coll0.get(k, 0) for k, v in coll1.items()
                           if v - coll0.get(k, 0)}
    metrics.observe(f"profile.{op}_s", dt)
    if rec.flops or rec.bytes_accessed:
        u = utilization(rec.flops, rec.bytes_accessed, dt, unit=rec.unit)
        metrics.gauge("profile.gflops_per_s", u["gflops_per_s"], op=op)
        metrics.gauge("profile.gbytes_per_s", u["gbytes_per_s"], op=op)
        metrics.gauge("profile.roofline_frac", u["roofline_frac"], op=op)
    if rec.temp_bytes:
        metrics.gauge("profile.temp_bytes", rec.temp_bytes, op=op)
    return out


def records() -> List[CostRecord]:
    """Every captured record (insertion order)."""
    with _lock:
        return list(_records.values())


def get(op: str, shape=None, config=None) -> Optional[CostRecord]:
    """The record for one signature, or None."""
    with _lock:
        return _records.get(_key(op, shape, config))


def snapshot() -> Dict[str, Any]:
    """JSON-safe dump: device peaks + one row per captured signature."""
    peaks = device_peaks()
    return {
        "device": dataclasses.asdict(peaks),
        "records": [r.row(peaks) for r in records()],
    }


def reset() -> None:
    """Drop every cost record and the collective counts."""
    with _lock:
        _records.clear()
        _collectives.clear()


# ---------------------------------------------------------------------------
# Device traces
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def device_trace(log_dir: str):
    """A ``torch.profiler`` window (host and, on a card, device activity)
    whose Chrome trace is written to ``<log_dir>/device_trace.json`` on
    exit, and the window's span trees (the roots that started in it,
    :func:`repro_torch.obs.trace.write_chrome_trace`) to
    ``<log_dir>/spans.json``. For its duration every host span is
    mirrored into a ``torch.profiler.record_function`` of the same name,
    so the kernels sit under the spans' names in the one file, and the
    spans' attributes are in the other, on the same clock (``ts`` plus
    each file's ``baseTimeNanoseconds``). Yields the profiler
    (``key_averages()``); yields None and records nothing when profiling
    is off. Span mirroring also needs spans, i.e. ``obs.enable()``.
    """
    if not _ENABLED:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile, record_function

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    trace.set_annotation_hook(record_function)
    t_start = time.time_ns()
    try:
        # The window's own range takes the set-up cost of a process's
        # first range (up to a millisecond between its start and its
        # return), which would otherwise put the first span's start that
        # far after its mirror's.
        with profile(activities=activities) as prof, \
                record_function("obs.device_trace"):
            yield prof
    finally:
        trace.set_annotation_hook(None)
    prof.export_chrome_trace(os.path.join(log_dir, "device_trace.json"))
    trace.write_chrome_trace(os.path.join(log_dir, "spans.json"),
                             since_ns=t_start)
