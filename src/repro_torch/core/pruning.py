"""Adjacency estimation given a causal order.

After DirectLiNGAM establishes the order, the connection strengths are
estimated by regressing each variable on its predecessors. The local
plan's least squares (OLS) takes every variable's weights at once from
one float64 Cholesky factor of the correlation matrix in causal order
(:func:`_ols_in_causal_order`), from a covariance of float64 sample
sums; nothing of size d^3 is built (at d = 2,048 the factor is one
34 MB (d, d) float64 matrix). The optional adaptive lasso refines the
same weights by FISTA on the weighted-L1 problem. The mesh plan's
sharded finish alone still solves identity-augmented stacks over its
pair-axis row tiles (:func:`ols_rows`).

With telemetry on, each least-squares solve is a ``prune.ols`` span
(attributes ``d``, ``rows``, ``estimator``: ``"factor"`` or
``"stacked"``, and ``system_bytes``: the bytes of the matrix factored or
of the stacked systems solved) and the FISTA sweeps a ``prune.lasso``
span (``iterations``, ``rows``, ``system_bytes``), both inside the fit's
``fit.pruning``; the counters ``prune.systems`` and
``prune.lasso_iterations`` add up the rows solved and the sweeps run.
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
    """Masked OLS solves for a tile of variables: the mesh plan's sharded
    finish, each rank solving its pair-axis row tile.

    Args:
      cov:       (d, d) covariance of the centered data.
      mask_rows: (tile, d) predecessor masks for the tile's variables.
      cov_rows:  (tile, d) the same variables' covariance rows.
    Returns:
      (tile, d) coefficient rows. Rows whose mask is all-False solve an
      identity system and come back zero.

    The identity-augmented systems are stacked into one (tile, d, d)
    batch for a single batched solve, tile x d^2 entries of ``cov``'s
    dtype: a rank's tile at d = 2,048 over 4 pair ranks is 8.6 GB in
    float32 before the solve's temporaries.
    """
    rows, d = mask_rows.shape
    obs_metrics.inc("prune.systems", rows)
    with obs_trace.span("prune.ols", d=d, rows=rows, estimator="stacked",
                        system_bytes=rows * d * d * cov.element_size()):
        mm = mask_rows[:, :, None] & mask_rows[:, None, :]
        diag = torch.where(mask_rows, EPS, 1.0)
        a = torch.where(mm, cov[None], 0.0) + torch.diag_embed(diag)
        b = torch.where(mask_rows, cov_rows, 0.0)
        # solve_ex: no host sync for the singularity check on the card.
        sol, _ = torch.linalg.solve_ex(a, b.unsqueeze(-1))
        return sol.squeeze(-1)


def ols_from_cov(cov, order):
    """OLS adjacency from a precomputed (ddof=0) covariance, in float64
    (:func:`_ols_in_causal_order`); B comes back in ``cov``'s dtype."""
    return _to_raw(_ols_in_causal_order, cov.double(), order).to(cov.dtype)


def ols_adjacency(x, order):
    """OLS adjacency: B[i, j] = coefficient of x_j in the least-squares
    regression of x_i on its causal predecessors. The covariance takes
    float64 sample sums, as the adaptive lasso's; B comes back in ``x``'s
    dtype."""
    return _to_raw(_ols_in_causal_order, _cov64(x), order).to(x.dtype)


def _cov64(x):
    """The (ddof=0) covariance of ``x`` (m, d) from float64 sums."""
    xd = x.double()
    xc = xd - xd.mean(dim=0, keepdim=True)
    return (xc.T @ xc) / x.shape[0]


def _to_raw(estimate, cov, order):
    """Run ``estimate`` on the correlation in causal order, from the
    float64 covariance ``cov``, and take its (d, d) result in causal
    positions back to the variables' own and to raw units."""
    sd = torch.clamp(torch.sqrt(torch.clamp(torch.diagonal(cov), min=0.0)),
                     min=1e-12)
    perm = torch.as_tensor(order, device=cov.device)
    corr = (cov / (sd[:, None] * sd[None, :]))[perm][:, perm]
    corr.diagonal().fill_(1.0)  # a constant variable: an identity row
    b_pos = estimate(corr)
    b_std = torch.empty_like(b_pos)
    b_std[perm[:, None], perm[None, :]] = b_pos
    return b_std * (sd[:, None] / sd[None, :])


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
    return _adaptive_lasso(_cov64(x), order, lam, gamma,
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

    It is the local plan's OLS, and the adaptive lasso's weights.
    Exactly collinear variables (a duplicated column) make the
    correlation singular: the factor fails, or rounding leaves a position
    less than :data:`EPS` of its variance unexplained by its predecessors
    and the weights after it split arbitrarily between the twins. Then it
    is taken with a ridge of :data:`EPS` on the diagonal, which picks the
    least-squares weights of least norm as the ridge goes to zero. (A
    gene screen's deepest genes keep ~2e-7 of their variance.)
    """
    d = corr.shape[0]
    obs_metrics.inc("prune.systems", d)
    with obs_trace.span("prune.ols", d=d, rows=d, estimator="factor",
                        system_bytes=d * d * corr.element_size()):
        eye = torch.eye(d, dtype=corr.dtype, device=corr.device)
        factor, info = torch.linalg.cholesky_ex(corr)
        unexplained = torch.diagonal(factor).square().min()
        if bool((info != 0) | (unexplained < EPS)):  # one host sync
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
    def estimate(corr):
        b_ols = _ols_in_causal_order(corr)
        w = 1.0 / torch.clamp(torch.abs(b_ols), min=1e-3) ** gamma
        return _fista_in_causal_order(corr, w, lam, n_steps)

    return _to_raw(estimate, cov, order)


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
