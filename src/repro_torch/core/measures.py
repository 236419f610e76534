"""Entropy measures used by the LiNGAM causal ordering.

Implements the maximum-entropy approximation of differential entropy from
Hyvarinen (1998), as used by DirectLiNGAM (Shimizu et al., 2011) and the
paper's Algorithm 1:

    H(u) ~= (1 + log(2*pi)) / 2
            - k1 * (E[log cosh u] - gamma)^2
            - k2 * (E[u * exp(-u^2 / 2)])^2

for a standardized (zero-mean, unit-variance) random variable ``u``. The
two expectations are the only sample-dependent quantities; the CUDA
kernel in ``repro_torch.kernels`` computes them for all variable pairs'
regression residuals.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels.nonlinearity import nonlinear_terms

# Constants of the Hyvarinen entropy approximation (same values as the
# reference lingam package and the paper's implementation).
K1 = 79.047
K2 = 7.4129
GAMMA = 0.37457

# H(standard normal) = (1 + log(2 pi)) / 2
_H_GAUSS = 0.5 * (1.0 + math.log(2.0 * math.pi))


def entropy_from_moments(m_logcosh, m_uexp):
    """Entropy approximation from the two nonlinear moments."""
    return _H_GAUSS - K1 * (m_logcosh - GAMMA) ** 2 - K2 * m_uexp**2


def nonlinear_moments(u: torch.Tensor, axis: int = -1):
    """E[log cosh u] and E[u exp(-u^2/2)] along ``axis``, accumulated in
    float64 and returned in ``u``'s dtype (each mean is then the same at
    every width of ``u``; see :mod:`repro_torch.core.ordering`)."""
    n = u.shape[axis]
    return tuple(
        (t.sum(dim=axis, dtype=torch.float64) / n).to(u.dtype)
        for t in nonlinear_terms(u)
    )


def entropy(u: torch.Tensor, axis: int = -1):
    """H(u) of standardized samples along ``axis``."""
    m1, m2 = nonlinear_moments(u, axis=axis)
    return entropy_from_moments(m1, m2)


def diff_mutual_info(h_xi, h_xj, h_ri_j, h_rj_i):
    """Difference of mutual information for the pair (i, j).

    Matches the paper's ``_diff_mutual_info``:
        (H(x_j) + H(r_i<-j / std)) - (H(x_i) + H(r_j<-i / std))
    Positive => i is more plausibly upstream of j.
    """
    return (h_xj + h_ri_j) - (h_xi + h_rj_i)
