"""The wide cell's check: one fit's causal order at drawn steps, its
least-squares adjacency and its residual variances, against float64, in
plain PyTorch and NumPy.

It imports neither the port nor the JAX package, and takes nothing the
port made but the order, the adjacency and the residual variances it
judges.

* ``order_gap_drawn`` -- as the gene cell's (``reference_gene``): at
  step 0 and at steps drawn from the seed, the float64 working data
  rebuilt by QR on the judged order's first k roots and scored with
  ``reference.step_scores``; the widest gap of the best score over the
  chosen variable's. A replay of the whole order at 8,192 x 2,048 costs
  about 20 minutes on the card; a step at most a few seconds.
* ``adjacency_err`` -- max |B - B_ref| / max |B_ref|, B_ref each
  variable's least-squares regression on the variables before it in the
  judged order, from one Householder QR of the centered float64 data in
  that order: with X P = Q R, regressing column i on columns 0..i-1
  leaves Q[:, i] R[i, i], so I - B_ref = diag(R) R^-T in causal
  positions. The data's QR, not the factor of their covariance the
  program takes: it never squares the condition number.
* ``resid_var_err`` -- max_i |v_i - v_ref,i| / v_ref,i, v_ref,i =
  R[i, i]^2 / m, the mean squared residual of that regression.

The control (:func:`control_numbers`) puts the reference itself in the
program's place in a lower precision: ``"lower"``, TF32 products,
bfloat16 integrands and float32 solves (``"bfloat16"`` is its stand-in
on a CPU). At each drawn step it picks its own root on the float64
working data, and the float64 gap of that pick is its reading; its
adjacency solves each variable's normal equations in float32 from the
mode's covariance, its residual variances come from the mode's
products. With no program, the prefixes and the order are the
generator's true order. It runs apart from the benchmark's runs, on the
card:

    python3 -m lingambench.lib.reference_wide --workload lingam-8k-2048.fit --seeds 11,12,13
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from . import reference, reference_gene

SOLVE_TILE = 64    # variables whose normal equations a control solves at once


def qr_least_squares(x, order):
    """(B, residual variances), float64, of each variable's least-squares
    regression on the variables before it in ``order``, from one QR of
    the centered data ``x`` (m, d) in that order (the module's
    docstring)."""
    m, d = x.shape
    perm = torch.as_tensor(np.asarray(order), device=x.device)
    xd = x.double()
    xc = (xd - xd.mean(dim=0, keepdim=True))[:, perm]
    r = torch.linalg.qr(xc, mode="r")[1]
    del xc
    eye = torch.eye(d, dtype=torch.float64, device=x.device)
    rinv_t = torch.linalg.solve_triangular(r.T, eye, upper=False)
    diag = torch.diagonal(r)
    b_pos = torch.tril(eye - diag[:, None] * rinv_t, -1)
    b = torch.empty_like(b_pos)
    b[perm[:, None], perm[None, :]] = b_pos
    v = torch.empty(d, dtype=torch.float64, device=x.device)
    v[perm] = diag * diag / m
    return b, v


def ols_normal_equations(cov, order, tile=SOLVE_TILE):
    """The control's B: each variable's normal equations on its
    predecessors, identity-augmented and solved in float32 (LU), a tile of
    ``tile`` variables at once, so no (d, d, d) stack is built."""
    d = cov.shape[0]
    order = torch.as_tensor(np.asarray(order), device=cov.device)
    pos = torch.empty_like(order)
    pos[order] = torch.arange(d, device=cov.device)
    mask = pos[None, :] < pos[:, None]          # j comes before i
    c = cov.float()
    out = torch.zeros((d, d), dtype=torch.float64, device=cov.device)
    for i0 in range(0, d, tile):
        mk = mask[i0:i0 + tile]
        a = torch.where(mk[:, :, None] & mk[:, None, :], c[None], 0.0)
        a = a + torch.diag_embed(torch.where(mk, 0.0, 1.0))
        rhs = torch.where(mk, c[i0:i0 + tile], 0.0)
        out[i0:i0 + tile] = torch.linalg.solve(a, rhs[..., None])[..., 0]
        del a
    return out


def adjacency_numbers(adjacency, resid_var, b_ref, v_ref) -> dict:
    """``adjacency_err`` and ``resid_var_err`` against the QR reference."""
    v = np.asarray(resid_var, dtype=np.float64)
    want = v_ref.cpu().numpy()
    return {
        "adjacency_err": reference.rel_err(adjacency, b_ref.cpu().numpy()),
        "resid_var_err": float(np.max(np.abs(v - want) / want)),
    }


def judge(x, order, adjacency, resid_var, steps, device) -> dict:
    """The cell's numbers for one fit; none (so the check fails) for an
    order that is not a permutation of the variables."""
    d = x.shape[1]
    order = np.asarray(order)
    if sorted(order.tolist()) != list(range(d)):
        print("reference_wide: the order is not a permutation",
              file=sys.stderr)
        return {}
    x64 = torch.as_tensor(x, device=device).double()
    b_ref, v_ref = qr_least_squares(x64, order)
    return {"order_gap_drawn": reference_gene.order_gap_drawn(x64, order,
                                                              steps),
            **adjacency_numbers(adjacency, resid_var, b_ref, v_ref)}


def control_numbers(x, order, steps, mode, device) -> dict:
    """The control's numbers: its own picks at ``steps`` (prefixes from
    ``order``), and its own adjacency and residual variances for
    ``order``, judged as the program's."""
    x64 = torch.as_tensor(x, device=device).double()
    b_ref, v_ref = qr_least_squares(x64, order)
    x32 = x64.float()
    b_ctl = ols_normal_equations(reference.covariance(x32, mode), order)
    v_ctl = reference.resid_var_from_data(x32, b_ctl, mode)
    return {"order_gap_drawn": reference_gene.order_gap_drawn(
                x64, order, steps, mode),
            **adjacency_numbers(b_ctl.cpu().numpy(), v_ctl, b_ref, v_ref)}


def main(argv=None, device=None):
    """The control on ``--seeds``: one JSON line a seed and mode."""
    p = argparse.ArgumentParser(prog="lingambench.lib.reference_wide")
    p.add_argument("--workload", default="lingam-8k-2048.fit")
    p.add_argument("--seeds", required=True)
    p.add_argument("--modes", default="lower",
                   help="comma-separated: lower, bfloat16")
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
                                      driver.steps(state), mode, device)
            print(json.dumps({"workload": cell.name, "seed": seed,
                              "mode": mode, "numbers": numbers,
                              "seconds": time.perf_counter() - t0}),
                  flush=True)
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
