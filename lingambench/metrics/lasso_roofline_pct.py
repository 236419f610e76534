"""`lasso_roofline_pct.<cell>`: the least time of the adaptive lasso's
FISTA sweeps over the device time of every kernel launched inside the
port's ``prune.lasso`` spans.

The least time is counted from what the estimator's inputs need,
whatever implements it. A sweep takes each gene's gradient over its
predecessors: p^2 multiply-adds for a gene with p predecessors, and the
p are 0, 1, ..., d - 1 in some order, so sum p^2 (about d^3 / 3) a
sweep, in float64 (the precision the configuration states) at the
card's FP64 tensor-core rate. And it reads the correlation's strictly
lower triangle and the iterate once and writes the iterate once: 3 d (d
- 1) / 2 float64 entries at the memory rate. The larger of the two
bounds a sweep; the iterations are the estimator's ``n_steps``, from
the configuration of the cells the metric lists. At d = 964 on an H100
the multiply-adds set it: 8.9 us a sweep, 3.6 ms for 400. A port
without the span, or a card missing from the table, reads nothing."""

from __future__ import annotations

import json

from lingambench.lib import spec

RANGES = ("prune.lasso",)
BYTES_PER_ENTRY = 8
# FP64 tensor-core multiply-adds a second by the name
# torch.cuda.get_device_name() gives (NVIDIA's data sheet: 67 TFLOP/s).
FP64_FMA_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e13,
}


def useful_fmas(d: int) -> int:
    """Multiply-adds of one sweep over d genes: sum_{p=0..d-1} p^2."""
    return (d - 1) * d * (2 * d - 1) // 6


def useful_bytes(d: int) -> int:
    """Bytes of one sweep over d genes: the correlation's strictly lower
    triangle read, the iterate read and written, in float64."""
    return 3 * d * (d - 1) // 2 * BYTES_PER_ENTRY


def least_seconds(d: int, iterations: int, fma_per_s: float,
                  bytes_per_s: float) -> float:
    """The least time of ``iterations`` sweeps over d genes."""
    return iterations * max(useful_fmas(d) / fma_per_s,
                            useful_bytes(d) / bytes_per_s)


def iterations(metric_name: str, checkout=spec.CHECKOUT):
    """The ``n_steps`` of the estimator the metric's cells state; None
    unless there is one."""
    bench = json.loads((checkout / "BENCHMARK.json").read_text())
    entry = next((m for m in bench["per_layer"]
                  if m["name"] == metric_name), None)
    if entry is None:
        return None
    cells = {w["name"]: w["config"] for w in bench["workloads"]}
    files = {c["name"]: c["file"] for c in bench["configs"]}
    found = set()
    for cell in entry.get("workloads", cells):
        cfg = json.loads((checkout / files[cells[cell]]).read_text())
        est = cfg.get("estimator")
        if not isinstance(est, dict) or "n_steps" not in est.get(
                "prune_kwargs", {}):
            return None
        found.add(int(est["prune_kwargs"]["n_steps"]))
    return found.pop() if len(found) == 1 else None


def read(ctx, metric):
    t, p = ctx.trace, ctx.peaks
    if t is None or p is None or not p.bytes_per_s:
        return None
    fma_per_s = FP64_FMA_PER_S.get(p.name)
    busy = t.device_s_in(RANGES[0])
    steps = iterations(metric.name)
    if not fma_per_s or not busy or not steps:
        return None
    least = sum(batch * least_seconds(d, steps, fma_per_s, p.bytes_per_s)
                for _, d, batch in ctx.shapes)
    return 100.0 * t.n_ops * least / busy
