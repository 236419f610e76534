"""Adjacency estimation given a causal order.

After DirectLiNGAM establishes the order, the connection strengths are
estimated by regressing each variable on its predecessors: a masked
batched OLS (one batched linear solve over all variables) plus an
optional adaptive-lasso refinement (FISTA on the weighted-L1 problem).
"""

from __future__ import annotations

import torch

EPS = 1e-9


def pred_mask(order):
    """(d, d) bool: mask[i, j] = True iff j precedes i in the causal order."""
    d = order.shape[0]
    pos = torch.empty(d, dtype=torch.long, device=order.device)
    pos[order] = torch.arange(d, device=order.device)
    return pos[None, :] < pos[:, None]


def ols_rows(cov, mask_rows, cov_rows):
    """Masked OLS solves for a tile of variables.

    Args:
      cov:       (d, d) covariance of the centered data.
      mask_rows: (tile, d) predecessor masks for the tile's variables.
      cov_rows:  (tile, d) the same variables' covariance rows.
    Returns:
      (tile, d) coefficient rows. Rows whose mask is all-False solve an
      identity system and come back zero.

    The identity-augmented systems are stacked into one (tile, d, d)
    batch for a single batched solve: 4 MB at d = 100, but 3.6 GB at
    d = 964, where a later slice has to solve in row tiles.
    """
    mm = mask_rows[:, :, None] & mask_rows[:, None, :]
    diag = torch.where(mask_rows, EPS, 1.0)
    a = torch.where(mm, cov[None], 0.0) + torch.diag_embed(diag)
    b = torch.where(mask_rows, cov_rows, 0.0)
    # solve_ex: no host sync for the singularity check on the card.
    sol, _ = torch.linalg.solve_ex(a, b.unsqueeze(-1))
    return sol.squeeze(-1)


def ols_from_cov(cov, order):
    """Masked OLS adjacency from a precomputed (ddof=0) covariance."""
    mask = pred_mask(order)
    return ols_rows(cov, mask, cov)


def ols_adjacency(x, order):
    """Batched masked OLS: B[i, j] = coefficient of x_j in the regression
    of x_i on its causal predecessors."""
    m = x.shape[0]
    xc = x - x.mean(dim=0, keepdim=True)
    cov = (xc.T @ xc) / m
    return ols_from_cov(cov, order)


def _soft_threshold(z, t):
    return torch.sign(z) * torch.clamp(torch.abs(z) - t, min=0.0)


def lasso_rows(cov, mask_rows, cov_rows, w_rows, lam, lip, n_steps):
    """FISTA adaptive-lasso solves for a tile of variables.

    Args:
      cov:       (d, d) correlation of the standardized data.
      mask_rows: (tile, d) predecessor masks.
      cov_rows:  (tile, d) correlation rows of the tile's variables.
      w_rows:    (tile, d) adaptive weights 1/|b_ols|^gamma.
    Returns:
      (tile, d) standardized-unit coefficient rows.
    """
    mm = mask_rows[:, :, None] & mask_rows[:, None, :]
    a = torch.where(mm, cov[None], 0.0)  # (tile, d, d)
    g = torch.where(mask_rows, cov_rows, 0.0)
    thresh = lam * w_rows / lip
    b = torch.zeros_like(g)
    y = b
    t = 1.0
    for _ in range(n_steps):
        grad = torch.bmm(a, y.unsqueeze(-1)).squeeze(-1) - g
        b_new = torch.where(
            mask_rows, _soft_threshold(y - grad / lip, thresh), 0.0
        )
        t_new = 0.5 * (1.0 + (1.0 + 4.0 * t * t) ** 0.5)
        y = b_new + ((t - 1.0) / t_new) * (b_new - b)
        b, t = b_new, t_new
    return b


def adaptive_lasso_adjacency(x, order, lam=0.01, gamma=1.0, n_steps=400):
    """Adaptive lasso via FISTA, weights w_j = 1/|b_ols_j|^gamma.

    Solved in standardized units (correlation matrix) so ``lam`` is
    dimensionless and the quadratic is well conditioned (L <= d); the
    coefficients are rescaled back to raw units at the end.
    """
    m, d = x.shape
    sd = torch.clamp(torch.std(x, dim=0, correction=0), min=1e-12)
    xc = (x - x.mean(dim=0, keepdim=True)) / sd
    cov = (xc.T @ xc) / m  # correlation
    mask = pred_mask(order)
    b_ols = ols_adjacency(x, order) * (sd[None, :] / sd[:, None])
    w = 1.0 / torch.clamp(torch.abs(b_ols), min=1e-3) ** gamma
    # Lipschitz bound: trace of the correlation matrix = d (cheap, safe).
    b_std = lasso_rows(cov, mask, cov, w, lam, float(d), n_steps)
    return b_std * (sd[:, None] / sd[None, :])


def adaptive_lasso_from_cov(cov, order, lam=0.01, gamma=1.0, n_steps=400):
    """Adaptive lasso from a precomputed (ddof=0) covariance (the same
    estimator as :func:`adaptive_lasso_adjacency`)."""
    d = cov.shape[0]
    sd = torch.clamp(torch.sqrt(torch.clamp(torch.diagonal(cov), min=0.0)),
                     min=1e-12)
    corr = cov / (sd[:, None] * sd[None, :])
    mask = pred_mask(order)
    b_ols = ols_from_cov(cov, order) * (sd[None, :] / sd[:, None])
    w = 1.0 / torch.clamp(torch.abs(b_ols), min=1e-3) ** gamma
    b_std = lasso_rows(corr, mask, corr, w, lam, float(d), n_steps)
    return b_std * (sd[:, None] / sd[None, :])


def apply_threshold(b, threshold: float):
    """Zero entries with |B_ij| < threshold (no-op for threshold <= 0)."""
    if threshold > 0.0:
        b = torch.where(torch.abs(b) >= threshold, b, 0.0)
    return b


def estimate_adjacency(
    x, order, method: str = "ols", threshold: float = 0.0, **kw
):
    """Adjacency matrix B with B[i, j] = direct effect of x_j on x_i."""
    if method == "ols":
        b = ols_adjacency(x, order)
    elif method == "adaptive_lasso":
        b = adaptive_lasso_adjacency(x, order, **kw)
    else:
        raise ValueError(f"unknown method: {method}")
    return apply_threshold(b, threshold)


def estimate_adjacency_from_cov(
    cov, order, method: str = "ols", threshold: float = 0.0, **kw
):
    """:func:`estimate_adjacency` from precomputed moments (no data pass)."""
    if method == "ols":
        b = ols_from_cov(cov, order)
    elif method == "adaptive_lasso":
        b = adaptive_lasso_from_cov(cov, order, **kw)
    else:
        raise ValueError(f"unknown method: {method}")
    return apply_threshold(b, threshold)
