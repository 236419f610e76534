"""Paper section 3.1 on the port: NOTEARS on the same simple layered-DAG
simulations, best F1 over the lambda grid {0.001, 0.005, 0.01, 0.05, 0.1}
(the paper reports F1 0.79+-0.2, recall 0.69+-0.2, SHD 2.52+-1.67: the
continuous-optimization method fails where DirectLiNGAM is exact), with
GOLEM (paper section 2.4), ICA-LiNGAM and DirectLiNGAM on the same DAGs.

    PYTHONPATH=src python3 -m benchmarks.torch_run --only notears [--full]

Every estimator runs on ``device``. NOTEARS and GOLEM are Python loops of
small launches (a few thousand Adam steps per fit), so this bench is
launch-bound on the card.
"""

from __future__ import annotations

import time

import numpy as np

from repro_torch.baselines.golem import golem_fit
from repro_torch.baselines.ica_lingam import ICALiNGAM
from repro_torch.baselines.notears import notears_fit
from repro_torch.core import DirectLiNGAM, api
from repro_torch.data.simulate import simulate_lingam

from benchmarks.torch_equivalence import f1_rec_shd

LAMS = (0.001, 0.005, 0.01, 0.05, 0.1)


def run(quick: bool = True, n_sims: int | None = None, device="cuda"):
    device = api.resolve_device(device)
    n = n_sims or (5 if quick else 50)
    m, d = (2_000, 10) if quick else (10_000, 10)
    inner = 300 if quick else 500
    nt_f1, nt_rec, nt_shd = [], [], []
    f1s = {"directlingam": [], "golem": [], "ica_lingam": []}
    seconds = {"notears_grid": 0.0, "directlingam": 0.0, "golem": 0.0,
               "ica_lingam": 0.0}
    for s in range(n):
        gt = simulate_lingam(m=m, d=d, seed=s)
        best = (-1.0, 0.0, float(d * d))
        t0 = time.perf_counter()
        for lam in LAMS:
            w = notears_fit(gt.data, lam=lam, inner_steps=inner, max_outer=8,
                            device=device)
            f1, rec, shd = f1_rec_shd(w, gt.adjacency)
            if f1 > best[0]:
                best = (f1, rec, float(shd))
        seconds["notears_grid"] += time.perf_counter() - t0
        nt_f1.append(best[0])
        nt_rec.append(best[1])
        nt_shd.append(best[2])
        for name, fit in (
            ("directlingam", lambda: DirectLiNGAM(
                prune_threshold=0.1, device=device).fit(gt.data).adjacency_),
            ("golem", lambda: golem_fit(
                gt.data, n_steps=1000 if quick else 3000, device=device)),
            ("ica_lingam", lambda: ICALiNGAM(
                n_steps=200, prune_threshold=0.1,
                device=device).fit(gt.data).adjacency_),
        ):
            t0 = time.perf_counter()
            b = fit()
            seconds[name] += time.perf_counter() - t0
            f1s[name].append(f1_rec_shd(b, gt.adjacency)[0])
    res = {
        "n_sims": n, "m": m, "d": d, "device": str(device),
        "notears_f1": float(np.mean(nt_f1)),
        "notears_f1_std": float(np.std(nt_f1)),
        "notears_recall": float(np.mean(nt_rec)),
        "notears_shd": float(np.mean(nt_shd)),
        "notears_shd_std": float(np.std(nt_shd)),
        "directlingam_f1": float(np.mean(f1s["directlingam"])),
        "golem_f1": float(np.mean(f1s["golem"])),
        "ica_lingam_f1": float(np.mean(f1s["ica_lingam"])),
        "seconds_per_sim": {k: v / n for k, v in seconds.items()},
    }
    print(
        f"torch_notears,n={n},"
        f"notears_f1={res['notears_f1']:.2f}+-{res['notears_f1_std']:.2f},"
        f"notears_shd={res['notears_shd']:.2f},"
        f"directlingam_f1={res['directlingam_f1']:.2f},"
        f"golem_f1={res['golem_f1']:.2f},"
        f"ica_lingam_f1={res['ica_lingam_f1']:.2f}"
    )
    return res
