"""Data generator for the paper's experiments (the port's own copy).

``simulate_lingam`` -- the paper's section 3.1 protocol: layered DAG (each
node's parents come from the previous layer), effects theta ~ N(0, 1),
noise e ~ Uniform(0, 1) (non-Gaussian, as LiNGAM requires). Given the
same arguments it returns the same arrays as the JAX package's
``repro.data.simulate.simulate_lingam``.

``simulate_var_stocks`` -- the paper's section 4.2 stand-in: a stationary
VAR(1) series with a sparse LiNGAM instantaneous graph (stock-like), the
same arrays as ``repro.data.simulate.simulate_var_stocks``.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class LingamGroundTruth:
    adjacency: np.ndarray  # B[i, j] = effect of x_j on x_i
    order: np.ndarray      # a valid causal order (topological)
    data: np.ndarray       # (m, d)


def _layered_dag(d: int, n_layers: int, edge_prob: float, rng) -> np.ndarray:
    """Layered DAG per §3.1: node at layer l draws parents from layer l-1."""
    layers = np.array_split(np.arange(d), n_layers)
    b = np.zeros((d, d), dtype=np.float64)
    for l in range(1, len(layers)):
        for i in layers[l]:
            for j in layers[l - 1]:
                if rng.random() < edge_prob:
                    b[i, j] = rng.standard_normal()  # theta ~ N(0, 1)
    return b


def simulate_lingam(
    m: int = 10_000,
    d: int = 10,
    n_layers: int = 3,
    edge_prob: float = 0.5,
    noise: str = "uniform",
    seed: int = 0,
    min_effect: float = 0.3,
) -> LingamGroundTruth:
    """Generate data from x = B x + e with a layered DAG.

    ``min_effect`` rescales tiny effects away from 0 so the recovery metrics
    are not dominated by statistically invisible edges (the paper's F1≈1
    regime). Noise is Uniform(0,1) by default, per the paper.
    """
    rng = np.random.default_rng(seed)
    b = _layered_dag(d, n_layers, edge_prob, rng)
    small = (np.abs(b) < min_effect) & (b != 0.0)
    b[small] = np.sign(b[small]) * min_effect

    if noise == "uniform":
        e = rng.uniform(0.0, 1.0, size=(m, d))
    elif noise == "laplace":
        e = rng.laplace(0.0, 1.0, size=(m, d))
    else:
        raise ValueError(noise)

    # x = (I - B)^{-1} e ; B is strictly lower-block-triangular by layers.
    x = np.linalg.solve(np.eye(d) - b, e.T).T
    order = np.arange(d)  # layered construction => identity is topological
    # Shuffle variable identities so the order is non-trivial.
    perm = rng.permutation(d)
    x = x[:, perm]
    b_perm = b[np.ix_(perm, perm)]
    inv = np.empty(d, dtype=int)
    inv[perm] = np.arange(d)
    order = inv[order]  # positions of original order in permuted ids
    # order must list *permuted* ids in causal order: original node k is now
    # called inv[k]; original order was 0..d-1 by construction.
    return LingamGroundTruth(adjacency=b_perm, order=order, data=x.astype(np.float32))


def simulate_var_stocks(
    m: int = 4000,
    d: int = 487,
    edge_prob: float = 0.01,
    ar_scale: float = 0.2,
    seed: int = 0,
):
    """Stationary VAR(1) with a LiNGAM instantaneous graph (stock-like).

    Returns (series, b0, m1): x(t) = B0 x(t) + M1 x(t-1) + e(t), i.e.
    x(t) = (I-B0)^{-1} (M1 x(t-1) + e(t)).
    """
    rng = np.random.default_rng(seed)
    b0 = np.zeros((d, d))
    for i in range(1, d):
        parents = rng.random(i) < edge_prob
        b0[i, :i][parents] = rng.standard_normal(parents.sum()) * 0.5
    m1 = rng.standard_normal((d, d)) * (rng.random((d, d)) < edge_prob)
    m1 *= ar_scale
    # Spectral-radius guard for stationarity.
    a = np.linalg.solve(np.eye(d) - b0, m1)
    rad = np.max(np.abs(np.linalg.eigvals(a)))
    if rad >= 0.95:
        m1 *= 0.9 / rad
    inv = np.linalg.inv(np.eye(d) - b0)
    x = np.zeros((m, d))
    e = rng.laplace(0.0, 1.0, size=(m, d))
    for t in range(1, m):
        x[t] = inv @ (m1 @ x[t - 1] + e[t])
    return x.astype(np.float32), b0, m1
