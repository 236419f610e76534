"""Frozen copies of the port's data generators
(``repro_torch.data.simulate.simulate_lingam`` and ``simulate_var_stocks``
as of the benchmark's first version).

The benchmark makes every input from ``--seed`` with these copies, so a
later change to the port's generators cannot change what is measured. A
CPU test holds them equal to the port's at a small size.
"""

from __future__ import annotations

import numpy as np


def _layered_dag(d: int, n_layers: int, edge_prob: float, rng) -> np.ndarray:
    layers = np.array_split(np.arange(d), n_layers)
    b = np.zeros((d, d), dtype=np.float64)
    for l in range(1, len(layers)):
        for i in layers[l]:
            for j in layers[l - 1]:
                if rng.random() < edge_prob:
                    b[i, j] = rng.standard_normal()
    return b


def simulate_lingam(m: int, d: int, n_layers: int = 3, edge_prob: float = 0.5,
                    noise: str = "uniform", seed: int = 0,
                    min_effect: float = 0.3):
    """x = B x + e over a layered DAG (each node's parents in the previous
    layer), effects N(0, 1) floored at ``min_effect``, noise U(0, 1) or
    Laplace(0, 1), variables shuffled. Returns (x float32 (m, d), B (d, d)
    float64, a true causal order)."""
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
    x = np.linalg.solve(np.eye(d) - b, e.T).T
    perm = rng.permutation(d)
    x = x[:, perm]
    b_perm = b[np.ix_(perm, perm)]
    inv = np.empty(d, dtype=int)
    inv[perm] = np.arange(d)
    return x.astype(np.float32), b_perm, inv[np.arange(d)]


def simulate_var_stocks(m: int, d: int, edge_prob: float = 0.01,
                        ar_scale: float = 0.2, seed: int = 0):
    """Stationary VAR(1) with a sparse LiNGAM instantaneous graph and
    Laplace noise: x(t) = (I - B0)^-1 (M1 x(t-1) + e(t)). Returns
    (x float32 (m, d), B0, M1)."""
    rng = np.random.default_rng(seed)
    b0 = np.zeros((d, d))
    for i in range(1, d):
        parents = rng.random(i) < edge_prob
        b0[i, :i][parents] = rng.standard_normal(parents.sum()) * 0.5
    m1 = rng.standard_normal((d, d)) * (rng.random((d, d)) < edge_prob)
    m1 *= ar_scale
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
