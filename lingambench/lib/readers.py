"""Arithmetic the metric readers share. A reader that finds nothing to
read returns None, and the harness leaves its metric out of the line."""

from __future__ import annotations

from typing import Optional

from . import roofline


def seconds_per_op(ctx) -> Optional[float]:
    """The window's seconds over the operations completed in it."""
    return ctx.window_s / ctx.n_ops if ctx.n_ops else None


def items_per_s(ctx) -> Optional[float]:
    """The items (resamples, ...) completed over the window's seconds."""
    return ctx.items / ctx.window_s if ctx.n_ops else None


def idle_pct(ctx) -> Optional[float]:
    t = ctx.trace
    if t is None or t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def range_roofline_pct(ctx, range_name: str) -> Optional[float]:
    """The least time of the orderings the traced operations needed over
    the device time of the kernels launched inside ``range_name``."""
    t, p = ctx.trace, ctx.peaks
    if t is None or p is None or not p.sfu_per_s or not p.bytes_per_s:
        return None
    busy = t.device_s_in(range_name)
    if not busy:
        return None
    least = t.n_ops * roofline.ordering_least_seconds(
        ctx.shapes, p.sfu_per_s, p.bytes_per_s)
    return 100.0 * least / busy


def range_device_ms_per_op(ctx, range_name: str) -> Optional[float]:
    t = ctx.trace
    if t is None or not t.device_s_in(range_name):
        return None
    return 1e3 * t.device_s_in(range_name) / t.n_ops


def launch_calls_per_op(ctx) -> Optional[float]:
    t = ctx.trace
    if t is None or not t.launch_calls:
        return None
    return t.launch_calls / t.n_ops
