"""A frozen copy of the port's Perturb-seq-like generator
(``repro_torch.data.simulate.simulate_gene_perturb`` as of the gene
cell's first version).

The port's version fills each gene's column as the product of the whole
(m, d) array with the gene's row of B, which takes about half a minute
at 65,164 x 964. This copy draws the same random numbers in the same
order and computes each column from its parents alone, in a gene-major
buffer: the same values up to the association of each column's sum (a
last-bit difference in float64, almost never seen after the cast to
float32). A CPU test holds it to the port's generator.
"""

from __future__ import annotations

import numpy as np

EFFECT_SCALE = 0.8
CLAMP = 5.0
CONTROL_SHARE = 0.2


def simulate_gene_perturb(m: int, d: int, n_interventions: int = 50,
                          edge_prob: float = 0.02, seed: int = 0):
    """A sparse LiNGAM SEM over d genes in topological order (gene i's
    parents among genes < i, each with probability ``edge_prob``, effects
    0.8 N(0, 1)), Laplace(0, 1) noise, and single-gene interventions: the
    first 80% of the m cells each have one gene of the first
    ``n_interventions`` clamped to 5.0 before its effects propagate, the
    rest are controls (target -1). Returns (x float32 (m, d) row-major,
    targets (m,) int64, B (d, d) float64)."""
    rng = np.random.default_rng(seed)
    b = np.zeros((d, d))
    for i in range(1, d):
        parents = rng.random(i) < edge_prob
        b[i, :i][parents] = rng.standard_normal(parents.sum()) * EFFECT_SCALE
    targets = np.full(m, -1, dtype=np.int64)
    n_int = int((1.0 - CONTROL_SHARE) * m)
    targets[:n_int] = rng.integers(0, n_interventions, size=n_int)
    e = rng.laplace(0.0, 1.0, size=(m, d))
    xt = np.ascontiguousarray(e.T)          # gene-major: a row per gene
    del e
    for i in range(d):
        parents = np.flatnonzero(b[i])
        if parents.size:
            xt[i] += b[i, parents] @ xt[parents]
        xt[i, targets == i] = CLAMP
    return np.ascontiguousarray(xt.T, dtype=np.float32), targets, b
