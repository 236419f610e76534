"""One run of one cell: set-up, warm-up, the measured window, the check,
and the last line.

    python3 lingambench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The window runs the cell's operation in a closed loop until ``--seconds``
have passed and finishes the one in flight; nothing is built or compiled
inside it, because the warm-up ran every shape first. ``setup_s`` runs
from the process's start to the first timed operation. ``--trace 1``
runs the same loop under ``torch.profiler`` (for at most the traffic's
``trace_ops`` operations) and reports the per-layer metrics instead of
the end-to-end ones.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import sys
import time
import traceback
from typing import Optional

import numpy as np

from . import imports, report, spec


@dataclasses.dataclass
class Run:
    cell: "spec.Cell"
    seed: int
    device: object           # torch.device
    program: bool = True     # False: inputs only (the control)


@dataclasses.dataclass
class Context:
    """What a metric reader reads."""

    n_ops: int
    items: int
    window_s: float
    setup_s: float
    shapes: list             # ordering shapes (m, d, batch) of one operation
    peaks: object            # device.Peaks or None
    trace: object            # tracing.TraceSummary or None


def parse(argv):
    p = argparse.ArgumentParser(prog="lingambench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _err(*a):
    print(*a, file=sys.stderr, flush=True)


def rng_for(seed: int, purpose: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed, purpose]))


def main(argv=None, *, device=None, t_start: Optional[float] = None) -> int:
    """Run one cell; returns the exit code. ``device`` skips the look for
    a card (the CPU tests pass the CPU)."""
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse(argv)
    try:
        cell = spec.load_cell(args.workload)
    except (spec.SpecError, KeyError) as e:
        _err(f"lingambench: {e}")
        return 2
    try:
        import repro_torch  # noqa: F401 - the system under test
    except ImportError as e:
        _err(f"lingambench: the port is not importable: {e}")
        return 2
    os.environ["REPRO_TORCH_TUNE_CACHE"] = str(spec.CHECKOUT / "build" / "tune")
    import torch

    from . import device as dev
    from . import tracing

    peaks = None
    if device is None:
        try:
            device = dev.require_cards(cell.chips)
        except dev.NoCard as e:
            _err(f"lingambench: {e}")
            return 3
        torch.cuda.set_device(device)
        peaks = dev.Peaks(device)
        _err(f"lingambench: {peaks.describe()}")
    torch.set_float32_matmul_precision("highest")
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    driver = cell.driver()
    run = Run(cell, args.seed, device)
    t_setup = time.perf_counter()
    state = driver.setup(run)
    t_warm = time.perf_counter()
    driver.warmup(state)
    sync()
    _err(f"lingambench: set-up {t_setup - t_start:.2f} s to the driver, "
         f"{t_warm - t_setup:.2f} s data and program, "
         f"{time.perf_counter() - t_warm:.2f} s warm-up; kernel builds "
         f"{_builds()}")

    prof = None
    cap = cell.traffic.get("trace_ops") if args.trace else None
    if args.trace:
        from repro_torch.obs import trace as obs_trace
        from torch.profiler import ProfilerActivity, profile, record_function

        obs_trace.enable()
        obs_trace.set_annotation_hook(record_function)
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                         else [])
        prof = profile(activities=acts)
        prof.__enter__()
        op_range = lambda: record_function(tracing.OP_RANGE)  # noqa: E731
    else:
        op_range = contextlib.nullcontext

    records, failed = [], 0
    t0 = time.perf_counter()
    while True:
        try:
            with op_range():
                records.append(driver.run_op(state, len(records)))
        except Exception:  # noqa: BLE001 - a failed operation is counted
            failed += 1
            traceback.print_exc()
            break
        now = time.perf_counter()
        if now - t0 >= args.seconds or (cap and len(records) >= cap):
            break
    sync()
    window_s = time.perf_counter() - t0
    setup_s = t0 - t_start

    summary = None
    if prof is not None:
        prof.__exit__(None, None, None)
        obs_trace.set_annotation_hook(None)
        obs_trace.disable()
        t_read = time.perf_counter()
        events = tracing.from_kineto(prof.profiler.kineto_results.events())
        summary = tracing.summarize(events, _range_names(cell))
        _err(f"lingambench: trace of {len(events)} events "
             f"{tracing.kinds(events)} read in "
             f"{time.perf_counter() - t_read:.1f} s")
        del prof, events
        if summary is not None:
            _err(f"lingambench: traced {summary.n_ops} operations, "
                 f"{summary.kernels} kernels, {summary.kernels_with_launch} "
                 f"matched to their launch calls, {summary.launch_calls} "
                 f"launch calls, device seconds by range "
                 f"{summary.device_s_by_range}; kernels with no launch call "
                 f"found {summary.unmatched}")

    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    n_ops = len(records)
    ctx = Context(n_ops, n_ops * driver.items_per_op(state), window_s,
                  setup_s, driver.shapes(state), peaks, summary)
    metrics = {}
    for m in (cell.per_layer if args.trace else cell.end_to_end):
        v = m.reader().read(ctx, m)
        if v is not None:
            metrics[m.name] = {"value": v, "unit": m.unit}

    driver.release(state)
    if cuda:
        torch.cuda.empty_cache()
    numbers = {}
    if records and not failed:
        t_check = time.perf_counter()
        from . import judge

        numbers = judge.judge(
            driver.answers(state, records, rng_for(args.seed, 1)), device,
            cell.limits["limits"])
        if hasattr(driver, "extra_numbers"):
            numbers.update(driver.extra_numbers(state, records))
        _err(f"lingambench: numbers {numbers}")
        _err(f"lingambench: reference check {time.perf_counter() - t_check:.1f} s")
    checks = report.compare(numbers, cell.limits["limits"])
    correct = report.passed(checks) and failed == 0

    dev_info = {"platform": "gpu" if cuda else device.type,
                "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                "count": cell.chips, "memory_peak_bytes": int(peak)}
    if args.trace:
        dev_info["busy_s"] = summary.busy_s if summary else 0.0
        dev_info["window_s"] = summary.window_s if summary else window_s
    bad = imports.loaded_forbidden()
    if bad:
        _err(f"lingambench: forbidden modules loaded: {bad}")
        return 4
    report.print_checks(checks)
    print(report.result_line(
        correct=correct, attempted=n_ops + failed, failed=failed,
        metrics=metrics, device=dev_info,
        breakdown=summary.breakdown if summary else None, checks=checks),
        flush=True)
    return 0


def _range_names(cell):
    """The host ranges the cell's per-layer metrics attribute to."""
    names = {"lingambench.op"}
    for m in cell.per_layer:
        names.update(getattr(m.reader(), "RANGES", ()))
    return sorted(names)


def _builds():
    from repro_torch.kernels import build

    return {k: round(v["seconds"], 3) for k, v in build.build_info.items()}
