"""Data generator for the paper's experiments (the port's own copy).

``simulate_lingam`` -- the paper's section 3.1 protocol: layered DAG (each
node's parents come from the previous layer), effects theta ~ N(0, 1),
noise e ~ Uniform(0, 1) (non-Gaussian, as LiNGAM requires). Given the
same arguments it returns the same arrays as the JAX package's
``repro.data.simulate.simulate_lingam``.

``simulate_var_stocks`` -- the paper's section 4.2 stand-in: a stationary
VAR(1) series with a sparse LiNGAM instantaneous graph (stock-like), the
same arrays as ``repro.data.simulate.simulate_var_stocks``.

``simulate_var_breaks`` -- the same VAR(1) + LiNGAM family with one
structural break (noise scale, weight shift or edge flip), the drift
monitor's test data: the same arrays as
``repro.data.simulate.simulate_var_breaks``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

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


BREAK_KINDS = ("edge_flip", "weight_shift", "noise_scale")


@dataclasses.dataclass
class VarBreak:
    """Ground truth of one simulated structural break."""

    series: np.ndarray      # (m, d) float32, break at row ``at``
    kind: str               # which mechanism changed
    at: int                 # first row generated by the new mechanism
    variable: int           # the variable whose mechanism changed
    b0_pre: np.ndarray      # (d, d) instantaneous graph before
    b0_post: np.ndarray     # (d, d) after (== pre for noise_scale)
    m1: np.ndarray          # (d, d) lag-1 matrix (unchanged)


def simulate_var_breaks(
    m: int = 4000,
    d: int = 12,
    kind: str = "noise_scale",
    at: Optional[int] = None,
    magnitude: float = 3.0,
    edge_prob: float = 0.15,
    ar_scale: float = 0.2,
    seed: int = 0,
) -> VarBreak:
    """VAR(1)+LiNGAM series with one structural break at row ``at``
    (default: mid-series). Three break kinds, matching the drift
    monitor's alert taxonomy:

    * ``"noise_scale"``  — one variable's exogenous-noise scale is
      multiplied by ``magnitude`` (graph unchanged);
    * ``"weight_shift"`` — one existing instantaneous edge's weight is
      shifted by ``magnitude`` times its magnitude (sign kept; the
      intercept-free analogue of a level shift, surfacing through the
      residual's second moments);
    * ``"edge_flip"``    — one instantaneous edge is removed and a new
      one (same child, different parent) appears, breaking the served
      graph's residual independence.

    The affected ``variable`` is always the *child* of the changed
    mechanism — the variable whose structural equation no longer holds
    — which is what the monitor should implicate. Pre-break dynamics
    come from the :func:`simulate_var_stocks` construction (laplace
    noise, stationarity-guarded lag matrix) so stationary-stream
    false-alarm calibration and break detection share one process
    family.
    """
    if kind not in BREAK_KINDS:
        raise ValueError(f"kind must be one of {BREAK_KINDS}, got {kind!r}")
    rng = np.random.default_rng(seed)
    at = m // 2 if at is None else int(at)

    b0 = np.zeros((d, d))
    for i in range(1, d):
        parents = rng.random(i) < edge_prob
        b0[i, :i][parents] = rng.standard_normal(parents.sum()) * 0.5
    # Guarantee at least one edge to break (tiny d / unlucky seed).
    if not np.any(b0):
        b0[d - 1, 0] = 0.5
    m1 = rng.standard_normal((d, d)) * (rng.random((d, d)) < edge_prob)
    m1 *= ar_scale
    a = np.linalg.solve(np.eye(d) - b0, m1)
    rad = np.max(np.abs(np.linalg.eigvals(a)))
    if rad >= 0.95:
        m1 *= 0.9 / rad

    # Break the strongest edge: the change must be statistically
    # meaningful for detection-delay measurements to mean anything.
    ei, ej = np.unravel_index(np.argmax(np.abs(b0)), b0.shape)
    noise_scale = np.ones(d)
    b0_post = b0.copy()
    if kind == "noise_scale":
        variable = int(ei)
        scale_post = noise_scale.copy()
        scale_post[variable] = magnitude
    elif kind == "weight_shift":
        variable = int(ei)
        b0_post[ei, ej] += np.sign(b0[ei, ej]) * magnitude * abs(b0[ei, ej])
        scale_post = noise_scale
    else:  # edge_flip
        variable = int(ei)
        b0_post[ei, ej] = 0.0
        # New parent for the same child: any earlier variable without
        # an existing edge into it (fall back to re-weighting ej).
        free = [j for j in range(ei) if j != ej and b0[ei, j] == 0.0]
        nj = free[rng.integers(len(free))] if free else int(ej)
        b0_post[ei, nj] = np.sign(rng.standard_normal() + 1e-9) * (
            magnitude * 0.3
        )
        scale_post = noise_scale

    inv_pre = np.linalg.inv(np.eye(d) - b0)
    inv_post = np.linalg.inv(np.eye(d) - b0_post)
    x = np.zeros((m, d))
    e = rng.laplace(0.0, 1.0, size=(m, d))
    for t in range(1, m):
        if t < at:
            x[t] = inv_pre @ (m1 @ x[t - 1] + e[t] * noise_scale)
        else:
            x[t] = inv_post @ (m1 @ x[t - 1] + e[t] * scale_post)
    return VarBreak(
        series=x.astype(np.float32), kind=kind, at=at, variable=variable,
        b0_pre=b0, b0_post=b0_post, m1=m1,
    )
