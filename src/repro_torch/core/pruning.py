"""Adjacency estimation given a causal order.

After DirectLiNGAM establishes the order, the connection strengths are
estimated by regressing each variable on its predecessors: a masked
batched OLS (one batched linear solve over all variables) plus an
optional adaptive-lasso refinement (FISTA on the weighted-L1 problem).

With telemetry on, each least-squares solve is a ``prune.ols`` span
(attributes ``d``, ``rows``, ``system_bytes``: the bytes of the systems
it solves) and the FISTA sweeps a ``prune.lasso`` span (``iterations``,
``rows``, ``system_bytes``), both inside the fit's ``fit.pruning``; the
counters ``prune.systems`` and ``prune.lasso_iterations`` add up the
systems solved and the sweeps run.
"""

from __future__ import annotations

import torch

from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace

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
    batch for a single batched solve: 4 MB at d = 100, 3.6 GB at d = 964
    in float32, where the stack and its temporaries take 11.9 GB of an
    H100's 80 (65,164 x 964, measured). At d ~ 2,000 a stack is 32 GB and
    the rows need tiles.
    """
    rows, d = mask_rows.shape
    obs_metrics.inc("prune.systems", rows)
    with obs_trace.span("prune.ols", d=d, rows=rows,
                        system_bytes=rows * d * d * cov.element_size()):
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


def adaptive_lasso_adjacency(x, order, lam=0.01, gamma=1.0, n_steps=400):
    """Adaptive lasso via FISTA, weights w_j = 1/|b_ols_j|^gamma.

    Solved in standardized units (correlation matrix) so ``lam`` is
    dimensionless and the quadratic is well conditioned (L <= d); the
    coefficients are rescaled back to raw units at the end. The
    covariance takes float64 sample sums, and the estimator runs in
    float64 (see :func:`_adaptive_lasso`); B comes back in ``x``'s dtype.
    """
    m = x.shape[0]
    xd = x.double()
    xc = xd - xd.mean(dim=0, keepdim=True)
    return _adaptive_lasso((xc.T @ xc) / m, order, lam, gamma,
                           n_steps).to(x.dtype)


def adaptive_lasso_from_cov(cov, order, lam=0.01, gamma=1.0, n_steps=400):
    """Adaptive lasso from a precomputed (ddof=0) covariance (the same
    estimator as :func:`adaptive_lasso_adjacency`)."""
    return _adaptive_lasso(cov.double(), order, lam, gamma,
                           n_steps).to(cov.dtype)


def _ols_in_causal_order(corr):
    """(d, d): row i the least-squares weights of causal position i on
    positions 0..i-1, from one Cholesky factor of the correlation in
    causal order. With corr = L L^T, the leading block of L factors each
    position's predecessors, and I - B = diag(L) L^-1.

    Exactly collinear genes (a duplicated column) make the correlation
    singular. Where the factor fails for it, it is taken with a ridge of
    :data:`EPS` on the diagonal, which picks the least-squares weights of
    least norm as the ridge goes to zero.
    """
    d = corr.shape[0]
    obs_metrics.inc("prune.systems", d)
    with obs_trace.span("prune.ols", d=d, rows=d,
                        system_bytes=d * d * corr.element_size()):
        eye = torch.eye(d, dtype=corr.dtype, device=corr.device)
        factor, info = torch.linalg.cholesky_ex(corr)
        if int(info):
            factor = torch.linalg.cholesky(corr + EPS * eye)
        inv = torch.linalg.solve_triangular(factor, eye, upper=False)
        return torch.tril(eye - torch.diagonal(factor)[:, None] * inv, -1)


def _fista_in_causal_order(corr, w, lam, n_steps):
    """FISTA (Beck and Teboulle 2009) from zero on every gene's weighted
    lasso at once, in causal order: position i regresses on positions
    0..i-1, so its gradient is row i of the iterate times the correlation,
    masked to the strictly lower triangle, and one (d, d) product a sweep
    serves all genes. Step 1 / d: the Lipschitz bound, the correlation's
    trace."""
    d = corr.shape[0]
    lip = float(d)
    obs_metrics.inc("prune.lasso_iterations", n_steps)
    with obs_trace.span("prune.lasso", iterations=n_steps, rows=d,
                        system_bytes=d * d * corr.element_size()):
        lower = torch.ones((d, d), dtype=torch.bool,
                           device=corr.device).tril(-1)
        g = torch.where(lower, corr, 0.0)
        thresh = lam * w / lip
        b = torch.zeros_like(g)
        y = b
        t = 1.0
        for _ in range(n_steps):
            grad = torch.where(lower, y @ corr, 0.0) - g
            b_new = torch.where(
                lower, _soft_threshold(y - grad / lip, thresh), 0.0
            )
            t_new = 0.5 * (1.0 + (1.0 + 4.0 * t * t) ** 0.5)
            y = b_new + ((t - 1.0) / t_new) * (b_new - b)
            b, t = b_new, t_new
        return b


def _adaptive_lasso(cov, order, lam, gamma, n_steps):
    """The adaptive lasso from a float64 covariance, in float64: the
    least-squares weights and the FISTA sweeps on the correlation in
    causal order (:func:`_ols_in_causal_order`,
    :func:`_fista_in_causal_order`), rescaled to raw units.

    float32 is not enough at a gene screen's size (65,164 x 964). There
    the correlation's condition number reaches ~3e9, the genes deep in
    the graph keeping ~2e-7 of their variance as their own noise, and
    standard deviations span 1.4 to ~2,000. float32 solves lose the
    weights altogether (B off by its own size), and float32 FISTA sweeps
    leave errors in correlation units that the rescale to raw units
    multiplies by the ratio of the standard deviations.
    """
    sd = torch.clamp(torch.sqrt(torch.clamp(torch.diagonal(cov), min=0.0)),
                     min=1e-12)
    perm = torch.as_tensor(order, device=cov.device)
    corr = (cov / (sd[:, None] * sd[None, :]))[perm][:, perm]
    corr.diagonal().fill_(1.0)  # a constant gene: an identity row
    b_ols = _ols_in_causal_order(corr)
    w = 1.0 / torch.clamp(torch.abs(b_ols), min=1e-3) ** gamma
    b_pos = _fista_in_causal_order(corr, w, lam, n_steps)
    b_std = torch.empty_like(b_pos)
    b_std[perm[:, None], perm[None, :]] = b_pos
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
