"""Paper Fig. 4 / Table 2 on the port: VarLiNGAM on stock-like VAR(1)
series (d=487 full, 64 quick). Reports the in/out-degree summary of
theta_0, the top-5 exerting / receiving nodes by total causal effect, and
theta_0's precision and recall against the simulated graph.

    PYTHONPATH=src python3 -m benchmarks.torch_run --only stocks [--full]
"""

from __future__ import annotations

import time

import numpy as np

from repro_torch.core import VarLiNGAM, api
from repro_torch.data.simulate import simulate_var_stocks


def run(quick: bool = True, device="cuda"):
    device = api.resolve_device(device)
    m, d = (1_500, 64) if quick else (4_000, 487)
    x, b0_true, _ = simulate_var_stocks(m=m, d=d, seed=0)
    t0 = time.perf_counter()
    model = VarLiNGAM(
        lags=1, prune_method="adaptive_lasso", prune_threshold=0.05,
        device=device,
    ).fit(x)
    fit_s = time.perf_counter() - t0
    th0, th1 = model.adjacency_matrices_[0], model.adjacency_matrices_[1]

    adj = np.abs(th0) > 0.05
    in_deg = adj.sum(axis=1)
    out_deg = adj.sum(axis=0)
    # total causal effects (paper: top exerting / receiving)
    exert = np.abs(th0).sum(axis=0) + np.abs(th1).sum(axis=0)
    recv = np.abs(th0).sum(axis=1) + np.abs(th1).sum(axis=1)
    top_exert = np.argsort(-exert)[:5].tolist()
    top_recv = np.argsort(-recv)[:5].tolist()
    leaves = [int(i) for i in np.where(out_deg == 0)[0][:5]]

    # structural quality vs ground truth
    tp = np.sum(adj & (b0_true != 0))
    prec = tp / max(adj.sum(), 1)
    rec = tp / max((b0_true != 0).sum(), 1)

    res = {
        "m": m, "d": d, "device": str(device), "fit_s": fit_s,
        "in_degree_mean": float(in_deg.mean()),
        "out_degree_mean": float(out_deg.mean()),
        "degree_symmetry": float(
            np.corrcoef(np.sort(in_deg), np.sort(out_deg))[0, 1]
        ),
        "top_exerting": top_exert,
        "top_receiving": top_recv,
        "leaf_nodes": leaves,
        "b0_precision": float(prec),
        "b0_recall": float(rec),
    }
    print(
        f"torch_stocks,d={d},fit={fit_s:.3f}s,"
        f"in_deg={res['in_degree_mean']:.2f},"
        f"out_deg={res['out_degree_mean']:.2f},"
        f"b0_precision={prec:.2f},b0_recall={rec:.2f},"
        f"top_exert={top_exert},top_recv={top_recv}"
    )
    return res
