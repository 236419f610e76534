"""The gene cell's check: one fit's causal order at drawn steps and its
adaptive-lasso adjacency, against float64, in plain PyTorch and NumPy.

It imports neither the port nor the JAX package, and takes nothing the
port made but the order and the adjacency it judges.

* ``order_gap_drawn`` -- at step 0 and at steps drawn from the seed,
  step k's working data is rebuilt in float64 as the residual of the
  active genes on the span of the constant and the first k roots of the
  judged order (QR). That is what DirectLiNGAM's sequential regressions
  give in exact arithmetic: each regresses the remaining columns on the
  previous root's residual, which is orthogonal to the constant and the
  roots before it. The step is scored with ``reference.step_scores``;
  the gap is the best score less the chosen gene's, and the number the
  widest gap of the drawn steps. A replay of the whole order, as the
  generic judge does, costs about 17 minutes at 65,164 x 964 on the card;
  a step costs about a second.
* ``lasso_adjacency_err`` -- max |B - B_ref| / max |B_ref|, B_ref the
  adaptive lasso for the judged order as the estimator defines it: the
  least-squares weights from the Cholesky reference, 1 / max(|b|, 1e-3)^gamma
  in correlation units, FISTA (Beck and Teboulle 2009) from zero with
  step 1 / d for ``n_steps`` iterations, masked to each gene's
  predecessors, rescaled to raw units. In causal positions the
  predecessor masks are the strictly lower triangle, so one iteration's
  gradients for all genes are one product Y C of the (d, d) iterate and
  the permuted correlation matrix.
* ``lasso_std_err_q90`` -- in correlation units (B taken back by the
  reference's standard deviations, B_ref before its rescale), each
  gene's largest error over B_ref's largest entry, and of those the 90th
  percentile over the genes. At a condition number of ~3e9 a float64
  solve's rounding moves the weights of a few genes, and through the
  soft threshold and 400 unconverged sweeps their rows, by up to ~1e-3:
  the largest error cannot tell float32 sweeps, which perturb nearly
  every gene's row, from float64 ones. The 90th percentile can.

The controls (:func:`control_numbers`) are put in the program's place.
``"lower"`` (TF32 products, bfloat16 integrands, float32 solves and
FISTA): at each drawn step it picks its own root on the float64 working
data, and the float64 gap of that pick is its reading; its adjacency is
the lasso computed in that mode. ``"fista32"``: the lasso with float64
weights and float32 sweeps, the precision the configuration rules out;
it reads no order. With no program, the prefixes of the drawn steps and
the lasso's order are the generator's true order. They run apart from
the benchmark's runs, on the card:

    python3 -m lingambench.lib.reference_gene --workload lingam-gene-964.fit --seeds 11,12,13 --modes lower,fista32
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from . import reference

MIN_WEIGHT_BASE = 1e-3   # the weights' floor on |b_ols|, as the estimator
GENE_QUANTILE = 0.9      # lasso_std_err_q90's quantile over the genes


def drawn_steps(d: int, n: int, rng: np.random.Generator) -> list:
    """Step 0 and ``n`` distinct further steps drawn from 1..d-1, sorted."""
    n = min(n, d - 1)
    more = rng.choice(np.arange(1, d), size=n, replace=False) if n else []
    return [0] + sorted(int(k) for k in more)


def working_data(x, order, k):
    """Step k's float64 working data: the residuals of the active genes
    (ascending) on the span of the constant and x's columns order[:k],
    with the active genes' indices."""
    m, d = x.shape
    chosen = [int(g) for g in order[:k]]
    taken = set(chosen)
    active = [g for g in range(d) if g not in taken]
    xa = x[:, active]
    z = torch.cat([torch.ones((m, 1), dtype=x.dtype, device=x.device),
                   x[:, chosen]], dim=1)
    q, _ = torch.linalg.qr(z)
    return xa - q @ (q.T @ xa), active


def step_gap(x, order, k, mode=None):
    """(gap, chosen gene) of step k: the float64 best score less the
    float64 score of order[k], or, with ``mode``, of the root the
    reference picks itself in that mode."""
    xw, active = working_data(x, order, k)
    with torch.no_grad(), reference.precision("reference"):
        scores = reference.step_scores(xw, "reference")[0]
    if mode is None:
        pos = active.index(int(order[k]))
    else:
        with torch.no_grad(), reference.precision(mode):
            pos = int(torch.argmax(reference.step_scores(xw, mode)[0]))
    return float(scores.max() - scores[pos]), active[pos]


def order_gap_drawn(x, order, steps, mode=None) -> float:
    """The widest gap over ``steps`` (see :func:`step_gap`)."""
    return max(step_gap(x, order, k, mode)[0] for k in steps)


def _soft(z, t):
    return torch.sign(z) * torch.clamp(torch.abs(z) - t, min=0.0)


def lasso_std(x, order, lam, gamma, n_steps, mode="reference"):
    """(B in correlation units, the standard deviations), float64: the
    adaptive lasso for ``order`` on data ``x`` (m, d), from the
    estimator's definition (the module's docstring), before the rescale
    to raw units. In ``"reference"`` every step is float64; in
    ``"fista32"`` only the sweeps are float32 (full float32 products); in
    a mode of ``reference.MODES`` the covariance and the FISTA products
    are the mode's, the least squares its float32 solves, the iterates
    float32."""
    m, d = x.shape
    prec = "reference" if mode == "fista32" else mode
    dt = torch.float64 if mode == "reference" else torch.float32
    with torch.no_grad(), reference.precision(prec):
        cov = reference.covariance(x, prec)
        sd = torch.clamp(torch.sqrt(torch.clamp(torch.diagonal(cov),
                                                min=0.0)), min=1e-12)
        b_ols = reference.ols_adjacency(cov, order, prec)
        w = 1.0 / torch.clamp(torch.abs(b_ols * (sd[None, :] / sd[:, None])),
                              min=MIN_WEIGHT_BASE) ** gamma
        perm = torch.as_tensor(np.asarray(order), device=x.device)
        c = (cov / (sd[:, None] * sd[None, :]))[perm][:, perm].to(dt)
        lower = torch.ones((d, d), dtype=torch.bool,
                           device=x.device).tril(-1)
        g = torch.where(lower, c, 0.0)
        thresh = (lam * w[perm][:, perm] / d).to(dt)
        b = torch.zeros_like(g)
        y = b
        t = 1.0
        for _ in range(n_steps):
            yc = (y @ c if prec == "reference"
                  else reference._product(y, c, mode).to(dt))
            grad = torch.where(lower, yc, 0.0) - g
            b_new = torch.where(lower, _soft(y - grad / d, thresh), 0.0)
            t_new = 0.5 * (1.0 + (1.0 + 4.0 * t * t) ** 0.5)
            y = b_new + ((t - 1.0) / t_new) * (b_new - b)
            b, t = b_new, t_new
        out = torch.empty((d, d), dtype=torch.float64, device=x.device)
        out[perm[:, None], perm[None, :]] = b.double()
        return out, sd


def to_raw(b_std, sd):
    """B in raw units from correlation units."""
    return b_std * (sd[:, None] / sd[None, :])


def adaptive_lasso(x, order, lam, gamma, n_steps, mode="reference"):
    """B (d, d), float64, in raw units (see :func:`lasso_std`)."""
    return to_raw(*lasso_std(x, order, lam, gamma, n_steps, mode))


def lasso_numbers(adjacency, b_ref_std, sd) -> dict:
    """The adjacency's numbers against the reference's B in correlation
    units and its standard deviations (see the module's docstring)."""
    b = torch.as_tensor(np.asarray(adjacency, dtype=np.float64),
                        device=sd.device)
    gene = ((b * (sd[None, :] / sd[:, None]) - b_ref_std).abs().amax(dim=1)
            / b_ref_std.abs().max()).cpu().numpy()
    return {
        "lasso_adjacency_err": reference.rel_err(
            b.cpu().numpy(), to_raw(b_ref_std, sd).cpu().numpy()),
        "lasso_std_err_q90": float(np.quantile(gene, GENE_QUANTILE)),
    }


def judge(x, order, adjacency, steps, prune_kwargs, device) -> dict:
    """The cell's numbers for one fit: ``order_gap_drawn`` over
    ``steps``, ``lasso_adjacency_err`` and ``lasso_std_err_q90``; none
    (so the check fails) for an order that is not a permutation of the
    genes."""
    d = x.shape[1]
    order = np.asarray(order)
    if sorted(order.tolist()) != list(range(d)):
        print("reference_gene: the order is not a permutation",
              file=sys.stderr)
        return {}
    x64 = torch.as_tensor(x, device=device).double()
    b_ref_std, sd = lasso_std(x64, order, **_lasso_args(prune_kwargs))
    return {"order_gap_drawn": order_gap_drawn(x64, order, steps),
            **lasso_numbers(adjacency, b_ref_std, sd)}


def control_numbers(x, order, steps, prune_kwargs, mode, device) -> dict:
    """The control's numbers: its own picks at ``steps`` (prefixes from
    ``order``; not in ``"fista32"``, whose order is the program's) and
    its own lasso for ``order``, judged as the program's."""
    x64 = torch.as_tensor(x, device=device).double()
    args = _lasso_args(prune_kwargs)
    b_ref_std, sd = lasso_std(x64, order, **args)
    b_ctl = adaptive_lasso(x64 if mode == "fista32" else x64.float(),
                           order, mode=mode, **args)
    numbers = lasso_numbers(b_ctl.cpu().numpy(), b_ref_std, sd)
    if mode != "fista32":
        numbers["order_gap_drawn"] = order_gap_drawn(x64, order, steps,
                                                     mode)
    return numbers


def _lasso_args(kw):
    return {"lam": float(kw["lam"]), "gamma": float(kw["gamma"]),
            "n_steps": int(kw["n_steps"])}


def main(argv=None, device=None):
    """The control on ``--seeds``: one JSON line a seed and mode."""
    p = argparse.ArgumentParser(prog="lingambench.lib.reference_gene")
    p.add_argument("--workload", default="lingam-gene-964.fit")
    p.add_argument("--seeds", required=True)
    p.add_argument("--modes", default="lower",
                   help="comma-separated: lower, bfloat16, fista32")
    args = p.parse_args(argv)
    from . import device as dev
    from . import runner, spec

    cell = spec.load_cell(args.workload)
    if device is None:
        device = dev.require_cards(cell.chips)
    driver = cell.driver()
    for seed in (int(s) for s in args.seeds.split(",")):
        state = driver.setup(runner.Run(cell, seed, device, program=False))
        for mode in args.modes.split(","):
            t0 = time.perf_counter()
            numbers = control_numbers(state["x"], state["true_order"],
                                      driver.steps(state), state["lasso"],
                                      mode, device)
            print(json.dumps({"workload": cell.name, "seed": seed,
                              "mode": mode, "numbers": numbers,
                              "seconds": time.perf_counter() - t0}),
                  flush=True)
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
