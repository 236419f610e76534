"""Bootstrap throughput on the port: the per-resample loop against the
batched ("vmap") engine -> BENCH_torch_bootstrap.json.

    PYTHONPATH=src python3 -m benchmarks.torch_run --only bootstrap [--full]

The reference bench (``benchmarks/bench_bootstrap.py``) on the card:
``bootstrap_lingam`` end to end (resample, refit, edge statistics) with
both strategies on cells from the ``lingam_workloads`` grid (``--full``:
each workload capped at (8192, 128), 20 resamples). The batched engine
orders every resample together with staged compaction, one batched B1
launch a step for all of them; the loop fits one resample after another
(d B1 launches each). Both draw the same resample indices (one
``torch.Generator`` seed), so the speed-up compares equal statistical
work, and ``edge_prob_agree`` holds the two strategies' edge
probabilities equal.
"""

from __future__ import annotations

import numpy as np

from repro_torch.configs.lingam_workloads import WORKLOADS
from repro_torch.core import api
from repro_torch.core.bootstrap import bootstrap_lingam
from repro_torch.data.simulate import simulate_lingam

from benchmarks.torch_common import clock, launch_counts, launches_since


def _cells(quick: bool):
    """(name, m, d, n_sampling): the reference bench's cells."""
    if quick:
        return [
            ("lingam-1m-100/quick", 1024, 64, 20),
            ("varlingam-stocks-487/quick", 2048, 32, 20),
        ]
    return [(w.name, min(w.m, 8192), min(w.d, 128), 20)
            for w in WORKLOADS.values()]


def run(quick: bool = True, device="cuda"):
    device = api.resolve_device(device)
    before = launch_counts()
    rows = []
    for name, m, d, n_sampling in _cells(quick):
        x = simulate_lingam(m=m, d=d, seed=0).data
        common = dict(n_sampling=n_sampling, threshold=0.05, seed=0,
                      device=device)
        # Warm-up: the kernels' build and plans, both strategies.
        bootstrap_lingam(x, strategy="vmap", **common)
        bootstrap_lingam(x, n_sampling=min(2, n_sampling), threshold=0.05,
                         seed=0, strategy="loop", device=device)

        counts = launch_counts()
        t0 = clock(device)
        res_v = bootstrap_lingam(x, strategy="vmap", **common)
        t_vmap = clock(device) - t0
        vmap_launches = launches_since(counts)

        counts = launch_counts()
        t0 = clock(device)
        res_l = bootstrap_lingam(x, strategy="loop", **common)
        t_loop = clock(device) - t0
        loop_launches = launches_since(counts)

        agree = bool(np.array_equal(res_v.edge_prob, res_l.edge_prob))
        rows.append({
            "cell": name, "m": m, "d": d, "n_sampling": n_sampling,
            "loop_s": t_loop, "vmap_s": t_vmap,
            "loop_fits_per_s": n_sampling / t_loop,
            "vmap_fits_per_s": n_sampling / t_vmap,
            "speedup": t_loop / t_vmap,
            "edge_prob_agree": agree,
            "edge_prob_max_diff": float(np.abs(res_v.edge_prob
                                               - res_l.edge_prob).max()),
            "vmap_launches": vmap_launches,
            "loop_launches": loop_launches,
        })
        print(f"torch_bootstrap,cell={name},m={m},d={d},n={n_sampling},"
              f"loop={t_loop:.2f}s,vmap={t_vmap:.2f}s,"
              f"speedup={t_loop / t_vmap:.2f}x,agree={agree},"
              f"vmap_launches={vmap_launches},loop_launches={loop_launches}")
    return {"device": str(device), "rows": rows,
            "launches": launches_since(before)}
