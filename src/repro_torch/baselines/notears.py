"""NOTEARS (Zheng et al., 2018) in PyTorch: the continuous-optimization
rival the paper evaluates in section 3.1.

    min_W  1/(2m) ||X - X W||_F^2 + lam ||W||_1
    s.t.   h(W) = tr(exp(W o W)) - d = 0

solved with the standard augmented-Lagrangian outer loop and an Adam inner
loop, as the JAX package's ``baselines/notears.py`` does: the gradient by
autograd, the inner loop a plain Python loop of small launches on the
fit's device. The paper's point, that NOTEARS fails to recover even simple
layered DAGs (F1 ~ 0.79), is reproduced by ``benchmarks/torch_notears.py``
with the same lambda grid {0.001..0.1}.

Two details follow the reference so that both take the same steps from
the same start: the L1 term's gradient at an exact zero is +lam (JAX's
``abs`` rule; torch's ``abs`` gives 0 there, and every fit starts at W = 0),
and Adam's bias corrections ``1 - beta^(i+1)`` are float32 powers, as the
reference computes them inside its loop.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core import api


def abs_sum(w):
    """sum |w| whose gradient at w = 0 is +1, as ``jnp.abs``'s."""
    return torch.where(w >= 0, w, -w).sum()


def _h_acyc(w):
    """tr(e^{W o W}) - d (differentiable acyclicity measure)."""
    return torch.trace(torch.linalg.matrix_exp(w * w)) - w.shape[0]


def _loss(w, x, lam, rho, alpha):
    m = x.shape[0]
    resid = x - x @ w
    mse = 0.5 / m * torch.sum(resid * resid)
    h = _h_acyc(w)
    return mse + lam * abs_sum(w) + 0.5 * rho * h * h + alpha * h


def loss_grad(loss, w, *args):
    """The gradient of ``loss(w, *args)`` with respect to ``w``."""
    w = w.detach().requires_grad_(True)
    with torch.enable_grad():
        (g,) = torch.autograd.grad(loss(w, *args), w)
    return g


def bias_corrections(step: int):
    """Adam's ``(1 - 0.9^(step+1), 1 - 0.999^(step+1))`` in float32."""
    k = np.float32(step + 1.0)
    one = np.float32(1.0)
    return (float(one - np.float32(0.9) ** k),
            float(one - np.float32(0.999) ** k))


def adam(grad_fn, w0, n_steps: int, lr: float):
    """``n_steps`` Adam steps (beta 0.9/0.999, bias-corrected) from
    ``w0``, zeroing the diagonal after each step (no self-loops)."""
    off_diag = 1.0 - torch.eye(w0.shape[0], dtype=w0.dtype, device=w0.device)
    w, m1, m2 = w0, torch.zeros_like(w0), torch.zeros_like(w0)
    for i in range(n_steps):
        g = grad_fn(w)
        m1 = 0.9 * m1 + 0.1 * g
        m2 = 0.999 * m2 + 0.001 * g * g
        c1, c2 = bias_corrections(i)
        w = w - lr * (m1 / c1) / (torch.sqrt(m2 / c2) + 1e-8)
        w = w * off_diag
    return w


def _inner_adam(w0, x, lam, rho, alpha, n_steps=300, lr=3e-2):
    return adam(lambda w: loss_grad(_loss, w, x, lam, rho, alpha), w0,
                n_steps, lr)


def notears_fit(
    x,
    lam: float = 0.01,
    max_outer: int = 12,
    h_tol: float = 1e-8,
    rho_max: float = 1e16,
    w_threshold: float = 0.3,
    inner_steps: int = 400,
    device="cuda",
):
    """Returns the thresholded weighted adjacency as a numpy array in the
    B[i, j] row convention of ``repro_torch.core`` (the optimization uses
    the column convention X ~ X W, W[j, i] for j -> i). Runs on
    ``device``: the card unless the caller asks for ``"cpu"``."""
    device = api.resolve_device(device)
    x = torch.tensor(np.asarray(x, np.float32), device=device)
    api._check_device(x)
    x = x - x.mean(dim=0, keepdim=True)
    d = x.shape[1]
    w = torch.zeros((d, d), dtype=torch.float32, device=device)
    rho, alpha, h = 1.0, 0.0, math.inf
    for _ in range(max_outer):
        while rho < rho_max:
            w_new = _inner_adam(w, x, lam, rho, alpha, n_steps=inner_steps)
            h_new = float(_h_acyc(w_new))
            if h_new > 0.25 * (h if h != math.inf else 1e30):
                rho *= 10.0
            else:
                break
        w, h = w_new, h_new
        alpha += rho * h
        if h <= h_tol or rho >= rho_max:
            break
    w = w.cpu().numpy()
    w[np.abs(w) < w_threshold] = 0.0
    return w.T  # B[i, j]: effect of x_j on x_i


def notears_grid(x, lams=(0.001, 0.005, 0.01, 0.05, 0.1), **kw):
    """Paper section 3.1 protocol: fit over the lambda grid, return all
    fits."""
    return {lam: notears_fit(x, lam=lam, **kw) for lam in lams}
