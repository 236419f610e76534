"""Plain-torch oracle for the pairwise-statistics kernel.

Given standardized data ``X_std`` of shape (m, d) and its sample
correlation matrix ``C`` (d, d), computes for every ordered pair (i, j):

    r_ij    = x_i - C[i, j] * x_j                 (regression residual)
    u_ij    = r_ij / std(r_ij) = r_ij / sqrt(1 - C[i, j]^2)
    M1[i,j] = E[log cosh u_ij]
    M2[i,j] = E[u_ij * exp(-u_ij^2 / 2)]

The identity std(r_ij) = sqrt(1 - C_ij^2) holds exactly in sample moments
when X is standardized with ddof=0 and C is the ddof=0 sample correlation,
so C must be a full-fp32 product (never TF32).

The oracle materializes the full (d, d, m) residual tensor: small
problems only. ``ops.pairwise_moments_blocked`` bounds the memory.
"""

from __future__ import annotations

import torch

from .nonlinearity import nonlinear_terms

EPS = 1e-12


def standardize(x: torch.Tensor, axis: int = 0, eps: float = EPS):
    """Zero-mean / unit-std (ddof=0) along ``axis``."""
    mu = torch.mean(x, dim=axis, keepdim=True)
    sd = torch.std(x, dim=axis, keepdim=True, correction=0)
    return (x - mu) / torch.clamp(sd, min=eps)


def correlation(x_std: torch.Tensor):
    """Sample correlation of standardized data, (m, d) -> (d, d)."""
    m = x_std.shape[0]
    return (x_std.T @ x_std) / m


def pairwise_moments_ref(x_std: torch.Tensor, c: torch.Tensor):
    """Oracle: full-materialization pairwise residual moments.

    Args:
      x_std: (m, d) standardized samples.
      c:     (d, d) sample correlation.
    Returns:
      (M1, M2): each (d, d), fp32. Diagonal entries are the moments of
      the degenerate self-residual; callers mask the diagonal.
    """
    xt = x_std.T.float()  # (d, m)
    c = c.float()
    r = xt[:, None, :] - c[:, :, None] * xt[None, :, :]  # (d, d, m)
    inv_std = torch.rsqrt(torch.clamp(1.0 - c * c, min=EPS))
    logcosh, uexp = nonlinear_terms(r * inv_std[:, :, None])
    return logcosh.mean(dim=-1), uexp.mean(dim=-1)
