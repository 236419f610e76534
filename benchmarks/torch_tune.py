"""Heuristic against tuned launch plans per shape bucket on the port
-> BENCH_torch_kernels.json.

    PYTHONPATH=src python3 -m benchmarks.torch_run --only tune [--full]

The cells are the reference bench's (``benchmarks/bench_tune.py``). A
``"pallas"`` cell runs the CUDA variant (backend ``None``: kernels B1,
B2 and B3 on the card), a ``"blocked"`` cell the plain variant. For each
cell the autotuner (:func:`repro_torch.kernels.tune.autotune.autotune_op`)
checks every candidate's sums bit for bit against the heuristic plan's,
times each, and the row reports the heuristic plan's time beside the
winner's. The port tunes only the pair-block edge T of B1/B2, so:

  * a ``"blocked"`` cell has one candidate (the plain version has
    nothing tunable): its speed-up is 1.0 by construction;
  * the B3 cell (``fused_moment_sums``) has one candidate, the fixed
    ``cuda-fused`` plan (B3's T is fixed; the reference tunes its
    Pallas blocks bi, bj, bm): the row is B3's time through the tuner,
    and its sums are held against a direct launch of B3 (bit for bit)
    and against B3's plain version (per sample, ``ATOL_FUSED``).

Measurements land in a throwaway overlay; neither
``$REPRO_TORCH_TUNE_CACHE`` nor ``build/tune/`` is touched. On the CPU
every candidate runs the plain version (the rows check the plumbing);
the card's rows are the product numbers.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile

from repro_torch.core import api
from repro_torch.kernels import fused_stats, ops
from repro_torch.kernels.tune import autotune, cache, registry

from benchmarks.torch_common import launch_counts, launches_since, sync

QUICK_CELLS = [
    ("pairwise_moments", "blocked", (512, 16), None),
    ("pairwise_moments", "blocked", (1024, 32), None),
    ("pairwise_moments", "pallas", (256, 16), None),
    ("pairwise_moment_sums_chunked", "blocked", (1024, 16), 256),
]
FULL_CELLS = [
    ("pairwise_moments", "blocked", (2048, 64), None),
    ("pairwise_moments", "blocked", (8192, 128), None),
    ("pairwise_moments", "pallas", (1024, 64), None),
    ("pairwise_moment_sums_rows", "pallas", (64, 64, 2048), 512),
    ("pairwise_moment_sums_chunked", "blocked", (4096, 64), 512),
    ("fused_moment_sums", "pallas", (8, 64, 1024), None),
]
# B3's sums against its plain version, per sample: the reference's
# fused-kernel tolerance (chip_smoke.py ATOL_FUSED).
ATOL_FUSED = 4e-6
# The port's backend for a reference cell's backend.
BACKENDS = {"pallas": None, "blocked": "blocked"}


def fused_check(shape, plan, device) -> dict:
    """B3's sums through the tuner's own runner (the inputs it timed,
    rebuilt from the same seed) against a direct launch and the plain
    version on those inputs."""
    import numpy as np

    tile, d, m = shape
    got = autotune._bench_fn("fused_moment_sums", shape, None, 1, device)(plan)
    x_raw, mu, rstd, c = autotune.fused_bench_inputs(shape, device)
    direct = ops.fused_moment_rows(x_raw, mu, rstd, c, 0, tile)
    plain = fused_stats.fused_moment_sums_plain(x_raw, mu, rstd, c, row0=0,
                                                rows=tile)
    off = ~np.eye(tile, d, dtype=bool)  # the pair (i, i) is undefined
    err = max(float(np.abs(a.cpu().double().numpy()
                           - b.cpu().double().numpy())[off].max())
              for a, b in zip(got, plain)) / m
    return {
        "sums_equal_direct_launch": all(bool((a == b).all())
                                        for a, b in zip(got, direct)),
        "sums_equal_plain": all(bool((a == b).all())
                                for a, b in zip(got, plain)),
        "max_abs_err_vs_plain_per_sample": err,
        "tolerance_per_sample": ATOL_FUSED,
        "within_tolerance": err <= ATOL_FUSED,
    }


def run_cell(op, ref_backend, shape, chunk, *, repeats, table, device):
    backend = BACKENDS[ref_backend]
    before = launch_counts()
    tuned = autotune.autotune_op(op, shape, backend=backend, chunk=chunk,
                                 repeats=repeats, device=device, table=table,
                                 persist=False)
    sync(device)
    launches = launches_since(before)
    heur = registry.dispatch_heuristic(op, shape, backend=backend,
                                       chunk=chunk, device=device)
    by_plan = {dataclasses.replace(m.plan, source=""): m.seconds
               for m in tuned.measurements}
    heur_s = by_plan.get(dataclasses.replace(heur, source=""))
    best_s = min(m.seconds for m in tuned.measurements)
    row = {
        "op": op,
        "backend": tuned.backend,
        "reference_backend": ref_backend,
        "shape": list(shape),
        "chunk": chunk,
        "bucket": cache.shape_bucket(op, shape),
        "device_kind": tuned.device_kind,
        "heuristic": {**heur.to_entry(), "us": (heur_s or 0.0) * 1e6},
        "tuned": {**tuned.best.to_entry(), "us": best_s * 1e6},
        "speedup_vs_heuristic": (heur_s / best_s
                                 if heur_s and best_s else 1.0),
        "n_candidates": len(tuned.measurements),
        "launches": launches,
    }
    if len(tuned.measurements) == 1:
        row["note"] = ("one candidate: "
                       + ("B3 has nothing tunable (its T is fixed)"
                          if op == "fused_moment_sums" else
                          "the plain version has nothing tunable")
                       + "; speed-up 1.0 by construction")
    if op == "fused_moment_sums":
        row["b3_check"] = fused_check(shape, tuned.best, device)
    return row


def run(quick: bool = True, device="cuda"):
    device = api.resolve_device(device)
    cells = QUICK_CELLS if quick else FULL_CELLS
    repeats = 2 if quick else 3
    before = launch_counts()
    rows = []
    with tempfile.TemporaryDirectory(prefix="repro-torch-tune-") as tmp:
        table = cache.TuneTable(
            overlay_path_=os.path.join(tmp, "overlay.json"))
        for op, ref_backend, shape, chunk in cells:
            row = run_cell(op, ref_backend, shape, chunk, repeats=repeats,
                           table=table, device=device)
            rows.append(row)
            print(f"torch_tune,op={op},backend={row['backend']},"
                  f"shape={tuple(shape)},"
                  f"heur_us={row['heuristic']['us']:.1f},"
                  f"tuned_us={row['tuned']['us']:.1f},"
                  f"speedup={row['speedup_vs_heuristic']:.2f},"
                  f"launches={row['launches']}")
    return {"device_kind": registry.device_kind(device), "rows": rows,
            "launches": launches_since(before)}
