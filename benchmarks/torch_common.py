"""What the port's engine benches share: a host clock read after the
device's queued work, and the moment kernels' launch counters.

The counters are the wrappers' own (``pairwise_stats.launches`` for B1,
``pairwise_stats.rows_launches`` for B2, ``fused_stats.launches`` for
B3): each adds one where it launches its kernel on the card, so on the
CPU, where the wrappers run the plain versions, every count stays 0.
"""

from __future__ import annotations

import time

import torch

from repro_torch.kernels import fused_stats, pairwise_stats


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def clock(device) -> float:
    """``time.perf_counter()`` once ``device`` has finished its queued
    work (the card is asynchronous: a host clock read without it times
    the enqueue)."""
    sync(device)
    return time.perf_counter()


def launch_counts() -> dict:
    """The three kernels' launch counts so far in this process."""
    return {"B1": pairwise_stats.launches, "B2": pairwise_stats.rows_launches,
            "B3": fused_stats.launches}


def launches_since(before: dict) -> dict:
    """Launches of each kernel since ``before`` (a :func:`launch_counts`)."""
    return {k: v - before[k] for k, v in launch_counts().items()}
