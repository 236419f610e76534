"""Faithful sequential (numpy, pair-loop) DirectLiNGAM: the paper's CPU
baseline and the semantic reference for the parallel implementation.

The port's own copy of the JAX package's ``baselines/sequential_lingam.py``
(numpy only, so it runs on the host beside the card): the same code, held
to the original by a parity test. It mirrors the paper's Algorithm 1
pseudocode literally: python loops over (i, j) pairs, per-pair
standardization, residual, entropy difference. The parallel
implementation in ``repro_torch.core`` must give the same causal order on
simulated data, up to ties between equally valid roots (paper Fig. 3).
"""

from __future__ import annotations

import numpy as np

K1 = 79.047
K2 = 7.4129
GAMMA = 0.37457


def _entropy(u: np.ndarray) -> float:
    """Hyvarinen max-entropy approximation for standardized u."""
    h_gauss = 0.5 * (1.0 + np.log(2.0 * np.pi))
    au = np.abs(u)
    logcosh = np.mean(au + np.log1p(np.exp(-2.0 * au)) - np.log(2.0))
    uexp = np.mean(u * np.exp(-0.5 * u * u))
    return h_gauss - K1 * (logcosh - GAMMA) ** 2 - K2 * uexp**2


def _residual(xi: np.ndarray, xj: np.ndarray) -> np.ndarray:
    """Residual of regressing xi on xj (ddof=0 moments)."""
    cov = np.mean(xi * xj) - np.mean(xi) * np.mean(xj)
    var = np.var(xj)
    return xi - (cov / max(var, 1e-12)) * xj


def _diff_mutual_info(xi_std, xj_std, ri_j, rj_i) -> float:
    sr_i = np.std(ri_j)
    sr_j = np.std(rj_i)
    return (_entropy(xj_std) + _entropy(ri_j / max(sr_i, 1e-12))) - (
        _entropy(xi_std) + _entropy(rj_i / max(sr_j, 1e-12))
    )


def search_causal_order(x: np.ndarray, u_idx: np.ndarray) -> int:
    """Algorithm 1: return the most exogenous variable among ``u_idx``."""
    mu = x[:, u_idx].mean(axis=0)
    sd = x[:, u_idx].std(axis=0)
    x_std = (x[:, u_idx] - mu) / np.maximum(sd, 1e-12)
    k_list = np.zeros(len(u_idx))
    for a, i in enumerate(u_idx):
        k = 0.0
        for b, j in enumerate(u_idx):
            if i == j:
                continue
            xi_std = x_std[:, a]
            xj_std = x_std[:, b]
            ri_j = _residual(xi_std, xj_std)
            rj_i = _residual(xj_std, xi_std)
            mi_diff = _diff_mutual_info(xi_std, xj_std, ri_j, rj_i)
            k += min(0.0, mi_diff) ** 2
        k_list[a] = -k
    return int(u_idx[int(np.argmax(k_list))])


def causal_order_sequential(x: np.ndarray) -> np.ndarray:
    """Full sequential ordering loop (the 96%-of-runtime procedure)."""
    x = np.array(x, dtype=np.float64, copy=True)
    d = x.shape[1]
    u_idx = list(range(d))
    order = []
    for _ in range(d):
        root = search_causal_order(x, np.array(u_idx))
        for i in u_idx:
            if i != root:
                x[:, i] = _residual(x[:, i], x[:, root])
        u_idx.remove(root)
        order.append(root)
    return np.array(order, dtype=np.int64)


def ols_adjacency_sequential(x: np.ndarray, order: np.ndarray) -> np.ndarray:
    """Per-variable OLS on causal predecessors (numpy lstsq)."""
    x = np.asarray(x, dtype=np.float64)
    d = x.shape[1]
    b = np.zeros((d, d))
    for p, i in enumerate(order):
        preds = order[:p]
        if len(preds) == 0:
            continue
        zp = x[:, preds] - x[:, preds].mean(axis=0)
        yi = x[:, i] - x[:, i].mean()
        coef, *_ = np.linalg.lstsq(zp, yi, rcond=None)
        b[i, preds] = coef
    return b


def fit_sequential(x: np.ndarray):
    order = causal_order_sequential(x)
    b = ols_adjacency_sequential(x, order)
    return order, b
