"""Paper Fig. 2 on the port: the causal-ordering sub-procedure, sequential
(the numpy pair loop on the host) against parallel (``repro_torch`` on
the card), over a (samples x dims) grid; plus the ordering's share of
the sequential fit (the paper: 96%).

    PYTHONPATH=src python3 -m benchmarks.torch_run --only speedup [--full]

For each shape: the sequential ordering seconds (one run; the host CPU
is named in the result), the port's ordering seconds with the CUDA kernel
and with the plain ``"blocked"`` backend and the whole
``DirectLiNGAM().fit`` seconds (each after one warm-up, device
synchronized, median of ``reps``), the speed-up (sequential over kernel
ordering), the ordering share of the sequential fit, and the kernel's
launches per ordering. Orders must be equal or part only at a tie
(:func:`benchmarks.torch_equivalence.parting_tie`).

The baseline is this repo's pure-Python pair loop
(``repro_torch.baselines.sequential_lingam``) on the card's host, not the
``lingam`` package the paper's 32x (an RTX 6000 Ada) was measured
against, so the ratio is this loop's on this host. With ``quick=False``
the port side alone also runs ``lingam-1m-100`` (1e6 x 100), beside the
paper's "7 hours on a CPU" for it (Fig. 2), quoted, not measured.
"""

from __future__ import annotations

import os
import platform
import time

import numpy as np
import torch

from repro_torch.baselines import sequential_lingam as seq
from repro_torch.configs.lingam_workloads import WORKLOADS
from repro_torch.core import DirectLiNGAM, api, ordering
from repro_torch.data.simulate import simulate_lingam
from repro_torch.kernels import pairwise_stats

from benchmarks.torch_common import sync
from benchmarks.torch_equivalence import parting_tie

QUICK_GRID = [(1_000, 8), (1_000, 16), (5_000, 16), (5_000, 32)]
FULL_GRID = [(10_000, 8), (10_000, 16), (10_000, 32), (50_000, 32),
             (10_000, 64), (100_000, 16)]
# Paper Fig. 2: "7 hours on a CPU" for the sequential fit at 1M x 100.
PAPER_SEQUENTIAL_S = 7 * 3600.0


def host_cpu() -> dict:
    """The host CPU as ``/proc/cpuinfo`` names it (its first processor's
    vendor, model name, family and model number; a sandbox may report the
    model name as "unknown"), its architecture and thread count."""
    fields = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if not line.strip():
                    break  # the first processor's block
                key, _, value = line.partition(":")
                fields[key.strip()] = value.strip()
    except OSError:
        pass
    return {"vendor": fields.get("vendor_id"),
            "model": fields.get("model name") or platform.processor(),
            "family": fields.get("cpu family"),
            "model_number": fields.get("model"),
            "machine": platform.machine(), "threads": os.cpu_count()}


def median_s(fn, device, reps=3):
    """(median seconds of ``reps`` runs after one warm-up, device
    synchronized around each, the last run's result)."""
    fn()
    times = []
    for _ in range(reps):
        sync(device)
        t0 = time.perf_counter()
        out = fn()
        sync(device)
        times.append(time.perf_counter() - t0)
    return float(np.median(times)), out


def shape_row(m, d, device, reps=3, seed=0) -> dict:
    """One shape of the grid: sequential against the port (see module
    docstring). Raises if the orders part where the scores do not tie."""
    gt = simulate_lingam(m=m, d=d, seed=seed)
    t0 = time.perf_counter()
    o_seq = seq.causal_order_sequential(gt.data)
    t_ord = time.perf_counter() - t0
    t0 = time.perf_counter()
    seq.ols_adjacency_sequential(gt.data, o_seq)
    t_reg = time.perf_counter() - t0

    x = torch.tensor(np.ascontiguousarray(gt.data), device=device)
    before = pairwise_stats.launches
    kernel_s, o_kernel = median_s(
        lambda: ordering.causal_order(x).cpu().numpy(), device, reps)
    launches = (pairwise_stats.launches - before) // (reps + 1)
    blocked_s, o_blocked = median_s(
        lambda: ordering.causal_order(x, backend="blocked").cpu().numpy(),
        device, reps)
    fit_s, _ = median_s(lambda: DirectLiNGAM(device=device).fit(gt.data),
                        device, reps)
    parts = {}
    for name, other in (("sequential", o_seq), ("blocked", o_blocked)):
        p, ratio = parting_tie(x, o_kernel, other, ordering.LocalReducer())
        if ratio > 1.0:
            raise RuntimeError(
                f"({m}, {d}): the kernel's order and the {name} order part "
                f"at position {p} by {ratio:.3f} of the tie tolerance")
        parts[name] = (p, ratio)
    row = {
        "m": m, "d": d,
        "sequential_s": t_ord,
        "sequential_ols_s": t_reg,
        "ordering_share": t_ord / (t_ord + t_reg),
        "kernel_ordering_s": kernel_s,
        "blocked_ordering_s": blocked_s,
        "fit_s": fit_s,
        "speedup": t_ord / kernel_s,
        "speedup_blocked": t_ord / blocked_s,
        "b1_launches_per_ordering": launches,
        "orders_equal_sequential": parts["sequential"][0] is None,
        "parting_sequential": parts["sequential"][0],
        "parting_gap_ratio_sequential": parts["sequential"][1],
        "orders_equal_blocked": parts["blocked"][0] is None,
        "parting_gap_ratio_blocked": parts["blocked"][1],
    }
    print(f"torch_speedup,m={m},d={d},seq={t_ord:.3f}s,"
          f"kernel={kernel_s:.4f}s,blocked={blocked_s:.4f}s,"
          f"fit={fit_s:.4f}s,speedup={row['speedup']:.1f}x,"
          f"ordering_share={row['ordering_share']:.3f},"
          f"b1_launches={launches},parting={parts['sequential'][0]}")
    return row


def headline(device, reps=3) -> dict:
    """The port alone at ``lingam-1m-100``: fit and ordering seconds."""
    wl = WORKLOADS["lingam-1m-100"]
    gt = simulate_lingam(m=wl.m, d=wl.d, seed=0)
    x = torch.tensor(np.ascontiguousarray(gt.data), device=device)
    row = {"workload": wl.name, "m": wl.m, "d": wl.d,
           "paper_sequential_s": PAPER_SEQUENTIAL_S,
           "paper_sequential_note": "paper Fig. 2, '7 hours on a CPU'; "
                                    "quoted, not measured"}
    row["fit_s"], _ = median_s(
        lambda: DirectLiNGAM(device=device).fit(gt.data), device, reps)
    row["ordering_s"], _ = median_s(
        lambda: ordering.causal_order(x).cpu().numpy(), device, reps)
    print(f"torch_speedup,{wl.name},fit={row['fit_s']:.3f}s,"
          f"ordering={row['ordering_s']:.3f}s,"
          f"paper_sequential={PAPER_SEQUENTIAL_S:.0f}s (quoted)")
    return row


def run(quick: bool = True, device="cuda"):
    device = api.resolve_device(device)
    grid = QUICK_GRID if quick else FULL_GRID
    res = {"device": str(device), "host_cpu": host_cpu(),
           "baseline": "repro_torch.baselines.sequential_lingam "
                       "(numpy pair loop) on the host",
           "reps": 3,
           "rows": [shape_row(m, d, device) for m, d in grid]}
    if not quick:
        res["lingam_1m_100"] = headline(device)
    return res
