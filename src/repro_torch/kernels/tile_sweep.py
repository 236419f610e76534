"""Time every pair-block instance of the pair-moment kernel on the widths
the fit paths launch it at, and score the launcher's tile rule.

Run on a CUDA card from the repository root:

    PYTHONPATH=src python3 -m repro_torch.kernels.tile_sweep

The paths and their cells are the autotuner's
(``tune.autotune.fit_path_cells``): B1 over ``lingam-1m-100``, B1 over
the VAR residuals of ``varlingam-stocks-487``, and the chunked B2 launch
over the 2048-row window of the rolling refit in 256-row slabs, at the
widths d .. 2 the local plan's ordering steps run at, a few widths a
tuning bucket, each weighted by the launches it stands for.

For every cell it times each instance of ``pairwise_stats.TILES`` (the
autotuner's candidate plans, ``tune.autotune.candidate_plans``, passed to
the wrapper as its explicit plan), checks that all instances give the
same bits, and prints one JSON line per cell. Then, for each path, it
prints the time of the path under ``tile_for`` with each candidate
``FILL_THREADS_PER_SM`` and under each single instance, and last the
candidate with the least time over all paths: the launcher's threshold
is read off these times. Each time is the autotuner's measurement
(``tune.autotune.measure_plan``): the device time of ``REPS``
back-to-back calls queued behind a device sleep, divided by ``REPS``, the
kernels' time without the host's launch gaps.
"""

from __future__ import annotations

import json
import subprocess

import numpy as np
import torch

from . import ops, pairwise_stats
from .pairwise_stats import tile_for
from .tune.autotune import candidate_plans, fit_path_cells, measure_candidates

REPS = 50
FILLS = (0, 64, 128, 256, 512, 1024, 2048, 4096)


def _sweep_cell(call, op, shape, chunk=None):
    """{tile: ms} of ``call(plan)`` at every candidate plan of ``op`` at
    ``shape``, whose sums must agree in bits (the autotuner's check)."""
    ms = measure_candidates(call, candidate_plans(op, shape, chunk=chunk),
                            repeats=REPS)
    return {m.plan.tile: m.seconds * 1e3
            for m in sorted(ms, key=lambda m: -m.plan.tile)}


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("tile_sweep needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rng = np.random.default_rng(0)

    def standardized(m, d):
        x = ops.standardize(torch.from_numpy(
            rng.laplace(size=(m, d)).astype(np.float32)).to(dev))
        return x, ops.correlation(x).contiguous()

    paths = {}
    for name, cells in fit_path_cells().items():
        op, (m, d), chunk, _ = cells[0]  # a path's cells: one op, m, chunk
        x, c = standardized(m, d)  # the widest cell first
        n_z = pairwise_stats.slab_plan(m, chunk).n_z
        swept = []
        for _, (_, width), _, steps in cells:
            xs = x[:, :width].contiguous()
            cs = c[:width, :width].contiguous()
            if chunk is None:
                def call(plan, xs=xs, cs=cs):
                    return ops.pairwise_moments(xs, cs, plan=plan)
            else:
                def call(plan, xs=xs, cs=cs):
                    return ops.pairwise_moment_sums_chunked(
                        xs, cs, chunk=chunk, plan=plan)
            swept.append((width, steps, n_z, _sweep_cell(
                call, op, tuple(xs.shape), chunk=chunk)))
        paths[name] = swept
        del x, c

    over_paths = dict.fromkeys(FILLS, 0.0)
    for name, cells in paths.items():
        for width, steps, n_z, times in cells:
            print(json.dumps({
                "path": name, "width": width, "launches": steps, "n_z": n_z,
                "picked": tile_for(width, width, n_z, sms),
                "ms": {str(t): v for t, v in times.items()},
            }))
        totals = {}
        for f in FILLS:
            totals[f"fill={f}"] = sum(
                steps * times[tile_for(width, width, n_z, sms, f)]
                for width, steps, n_z, times in cells)
            over_paths[f] += totals[f"fill={f}"]
        for tile in pairwise_stats.TILES:
            totals[f"only {tile}"] = sum(steps * times[tile]
                                         for _, steps, _, times in cells)
        totals["best per cell"] = sum(steps * min(times.values())
                                      for _, steps, _, times in cells)
        print(json.dumps({"path": name, "path_ms": totals}))
    print(json.dumps({
        "all_paths_ms": {f"fill={f}": t for f, t in over_paths.items()},
        "best_fill": min(over_paths, key=over_paths.get),
        "FILL_THREADS_PER_SM": pairwise_stats.FILL_THREADS_PER_SM}))
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
