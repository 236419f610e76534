"""Paper Table 1 on the port: interventional gene-expression evaluation.

    PYTHONPATH=src python3 -m benchmarks.torch_run --only gene [--full]

No Perturb-CITE-seq offline -> the synthetic Perturb-seq-like generator
with the same protocol as the JAX package's ``benchmarks/bench_gene.py``:
train on 80% of the interventions, hold out 20%, fit DirectLiNGAM
(adaptive lasso, lam 0.02) and NOTEARS (on the first 2000 training rows),
then score the held-out interventions with a Stein-VI (SVGD) posterior
over the SEM's noise scale: I-NLL and I-MAE. NOTEARS stands for the
continuous-optimization comparator (DCD-FG in the paper). Full size is
the paper's gene width: m = 50,000, d = 961, 192 interventions.

Both estimators and SVGD run on ``device``. DirectLiNGAM runs with
staged compaction, which gives the order of compaction "none" with about
0.43 of its pair work. The SVGD particles start from a standard-normal
draw of a ``torch.Generator`` on the device (another stream than
``jax.random``); ``particles`` passes that (32, 1) draw explicitly.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.baselines.notears import notears_fit
from repro_torch.core import DirectLiNGAM, api
from repro_torch.data.simulate import simulate_gene_perturb
from repro_torch.kernels import pairwise_stats
from repro_torch.vi.svgd import svgd

N_PARTICLES = 32


@dataclasses.dataclass
class GeneData:
    x: np.ndarray          # (m, d) all cells
    targets: np.ndarray    # (m,) intervened gene, -1 for controls
    adjacency: np.ndarray  # (d, d) true B
    held_out: np.ndarray   # held-out intervention targets
    x_train: np.ndarray    # cells of the training interventions


def gene_data(quick: bool = True) -> GeneData:
    """The study's data and its 80/20 intervention split (seed 0)."""
    m, d, n_int = (4_000, 64, 16) if quick else (50_000, 961, 192)
    x, targets, b_true = simulate_gene_perturb(
        m=m, d=d, n_interventions=n_int, seed=0
    )
    rng = np.random.default_rng(0)
    held_out = rng.choice(n_int, size=max(2, n_int // 5), replace=False)
    train_mask = ~np.isin(targets, held_out)
    return GeneData(x, targets, b_true, held_out, x[train_mask])


def _interventional_scores(b_adj, x, targets, held_out, noise_scale):
    """Predict distribution of downstream genes under held-out interventions
    via the SEM x = Bx + e; score NLL and MAE on observed cells."""
    d = b_adj.shape[0]
    eye = np.eye(d)
    try:
        inv = np.linalg.inv(eye - b_adj)
    except np.linalg.LinAlgError:
        inv = np.linalg.pinv(eye - b_adj)
    nlls, maes = [], []
    for g in held_out:
        cells = x[targets == g]
        if len(cells) == 0:
            continue
        # do(x_g = v): propagate the intervention's mean effect
        v = float(np.mean(cells[:, g]))
        e_mean = np.zeros(d)
        e_mean[g] = v  # exogenous override at the intervened node
        mu = inv @ e_mean
        mu[g] = v
        var = noise_scale**2 * np.maximum((inv**2).sum(axis=1), 1e-6)
        nll = 0.5 * np.mean(
            np.log(2 * np.pi * var)[None, :]
            + (cells - mu[None, :]) ** 2 / var[None, :]
        )
        mae = np.mean(np.abs(cells.mean(axis=0) - mu))
        nlls.append(nll)
        maes.append(mae)
    return float(np.mean(nlls)), float(np.mean(maes))


def noise_scale_posterior(b, x_train, device, particles=None):
    """SVGD over the global log noise scale given the fit's residuals;
    returns exp of the particles' mean."""
    resid = x_train - x_train @ b.T
    emp = np.std(resid, axis=0).mean()
    width = float(0.1 * emp + 1e-6)  # numpy, as the reference evaluates it
    emp_f = float(emp)

    def logp(z):
        s = torch.exp(z[0])
        return -0.5 * ((s - emp_f) / width) ** 2

    if particles is None:
        gen = torch.Generator(device=device).manual_seed(0)
        z0 = torch.randn((N_PARTICLES, 1), generator=gen, device=device)
    else:
        z0 = torch.as_tensor(np.array(particles, dtype=np.float32),
                             device=device)
    parts = z0 * 0.1 + float(np.log(emp + 1e-6))
    parts = svgd(parts, logp, n_steps=200, step_size=1e-2)
    return float(np.exp(parts.cpu().numpy().mean()))


def run(quick: bool = True, device="cuda", particles=None,
        data: GeneData = None):
    """I-NLL / I-MAE of DirectLiNGAM and NOTEARS, with each fit's seconds
    (and DirectLiNGAM's moment-kernel launches). ``data`` reuses a
    :func:`gene_data` result."""
    device = api.resolve_device(device)
    data = data or gene_data(quick)
    x_train = data.x_train
    d = data.x.shape[1]
    results = {"m": int(data.x.shape[0]), "d": d,
               "m_train": int(x_train.shape[0]),
               "n_held_out": int(len(data.held_out)), "device": str(device)}
    for name, fit in (
        ("directlingam", lambda: DirectLiNGAM(
            prune_method="adaptive_lasso", prune_kwargs=dict(lam=0.02),
            compaction="staged", device=device,
        ).fit(x_train).adjacency_),
        ("notears", lambda: notears_fit(
            x_train[: min(len(x_train), 2000)], lam=0.05,
            inner_steps=200, max_outer=6, device=device,
        )),
    ):
        before = pairwise_stats.launches
        t0 = time.perf_counter()
        b = np.asarray(fit())
        fit_s = time.perf_counter() - t0
        launches = pairwise_stats.launches - before
        t0 = time.perf_counter()
        noise_scale = noise_scale_posterior(b, x_train, device, particles)
        svgd_s = time.perf_counter() - t0
        nll, mae = _interventional_scores(b, data.x, data.targets,
                                          data.held_out, noise_scale)
        results[name] = {"inll": nll, "imae": mae, "fit_s": fit_s,
                         "svgd_s": svgd_s, "noise_scale": noise_scale,
                         "b1_launches": launches,
                         "edges": int(np.count_nonzero(b))}
        print(f"torch_gene,{name},inll={nll:.3f},imae={mae:.3f},d={d},"
              f"fit={fit_s:.2f}s,b1_launches={launches}")
    return results
