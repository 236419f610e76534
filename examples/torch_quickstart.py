"""Quickstart: causal discovery with the PyTorch/CUDA port on one card.

    PYTHONPATH=src python3 examples/torch_quickstart.py [--device cpu]

Simulates data from a known layered DAG (paper section 3.1 protocol),
runs the parallel DirectLiNGAM on the card, verifies it against the
sequential reference, compares the CUDA kernel backend with the plain
``"blocked"`` backend, prints the recovered adjacency, then *uses* the
graph: total-effect queries, a do-intervention, and root-cause
attribution of an anomalous sample (the full discovery -> query path).
``--device cpu`` runs everything on the CPU, where the kernel's plain
version takes the kernel's place. (The JAX package's ``--telemetry`` and
``--profile`` sections wait for the port's telemetry layer.)
"""

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.baselines.sequential_lingam import (  # noqa: E402
    causal_order_sequential,
)
from repro_torch.core import (  # noqa: E402
    DirectLiNGAM,
    VarLiNGAM,
    api,
    batched,
)
from repro_torch.core.bootstrap import bootstrap_lingam  # noqa: E402
from repro_torch.data.simulate import (  # noqa: E402
    simulate_do,
    simulate_lingam,
    simulate_var_stocks,
)
from repro_torch.infer import effects, intervene, rca  # noqa: E402


def main(device: str) -> None:
    print("=== DirectLiNGAM (paper Algorithm 1, parallel) ===")
    gt = simulate_lingam(m=5_000, d=10, seed=0)
    model = DirectLiNGAM(prune_threshold=0.1, device=device).fit(gt.data)
    sequential = causal_order_sequential(gt.data)
    print("causal order :", model.causal_order_)
    print("sequential   :", sequential)
    agree = np.array_equal(model.causal_order_, sequential)
    print(f"parallel == sequential: {agree}")

    est = np.abs(model.adjacency_) > 0.1
    true = gt.adjacency != 0
    print(f"edges: true={true.sum()} recovered={est.sum()} "
          f"correct={np.sum(est & true)}")

    kernel = "cuda" if device == "cuda" else None
    print(f"\n=== moment backend {kernel!r} against 'blocked' ===")
    model_k = DirectLiNGAM(backend=kernel, device=device).fit(gt.data)
    model_b = DirectLiNGAM(backend="blocked", device=device).fit(gt.data)
    print(f"{kernel!r} order :", model_k.causal_order_)
    print("'blocked' order:", model_b.causal_order_)
    print("orders agree :", np.array_equal(model_k.causal_order_,
                                           model_b.causal_order_))

    print("\n=== Functional core: fit_fn + batched bootstrap ===")
    x = torch.as_tensor(gt.data, device=api.resolve_device(device))
    res = api.fit_fn(x.contiguous(), api.FitConfig())
    print("fit_fn order  :", res.order.cpu().numpy())
    print("resid_var[:4] :", res.resid_var[:4].cpu().numpy().round(3))

    boot = bootstrap_lingam(gt.data, n_sampling=10, threshold=0.1, seed=0,
                            strategy="vmap", device=device)
    print("stable edges (P>=0.8):",
          [(i, j, p) for i, j, p, _ in boot.stable_edges(0.8)][:5])

    # fit_many: one batched program fitting an ensemble of datasets.
    xs = torch.stack([
        torch.as_tensor(np.ascontiguousarray(
            simulate_lingam(m=2_000, d=10, seed=s).data))
        for s in range(4)
    ]).to(api.resolve_device(device))
    ens = batched.fit_many(xs, api.FitConfig(compaction="staged"))
    print("fit_many orders (4 datasets):")
    print(ens.order.cpu().numpy())

    print("\n=== VarLiNGAM (paper section 3.2) ===")
    xv, b0, _ = simulate_var_stocks(m=2_000, d=20, edge_prob=0.1, seed=1)
    var_model = VarLiNGAM(lags=1, prune_threshold=0.05,
                          device=device).fit(xv)
    th0 = var_model.adjacency_matrices_[0]
    tp = np.sum((np.abs(th0) > 0.05) & (b0 != 0))
    print(f"instantaneous edges: true={np.sum(b0 != 0)} "
          f"recovered-correct={tp}")

    print("\n=== Causal queries on the fitted graph (repro_torch.infer) ===")
    # Total effects: (I - B)^-1 by triangular solve in causal order.
    t = effects.total_effects(model.result_).cpu().numpy()
    off = np.abs(t) * (1 - np.eye(t.shape[0]))
    i, j = np.unravel_index(np.argmax(off), t.shape)
    print(f"strongest total effect: x{j} -> x{i} = {t[i, j]:+.3f} "
          f"(direct {model.adjacency_[i, j]:+.3f})")

    # Intervention: predicted do(x_j = +2) mean vs interventional sampling.
    mu_do, _ = intervene.interventional_moments(
        model.result_, {int(j): 2.0},
        mean=gt.data.mean(axis=0), cov=np.cov(gt.data.T, ddof=0),
    )
    mc = simulate_do(gt.adjacency, {int(j): 2.0}, m=20_000, seed=0)
    print(f"do(x{j}=2): predicted E[x{i}]={mu_do[i]:+.3f}  "
          f"Monte-Carlo={mc[:, i].mean():+.3f}")

    # Root-cause attribution: inject an anomaly into x_j's noise term
    # and ask the graph who broke.
    x_anom = gt.data[:1].copy()
    x_anom[0] += 4.0 * t[:, j]  # shift j's noise by +4, propagated
    report = rca.attribute(
        model.result_, x_anom, mean=gt.data.mean(axis=0), target=int(i)
    )
    print(f"RCA: implicated root = x{report.root[0]} (injected x{j}); "
          f"ranking {report.ranking(top_k=3)}")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the fits run (default: the card)")
    main(ap.parse_args().device)
