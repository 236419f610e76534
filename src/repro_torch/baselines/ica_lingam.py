"""ICA-LiNGAM (Shimizu et al., 2006): the original LiNGAM estimator, the
in-family baseline ("the ideas presented are easily applicable to other
LiNGAM variants", paper section 1). The JAX package's
``baselines/ica_lingam.py`` on the fit's device:

  1. FastICA (deflation, logcosh contrast) on the device recovers W such
     that s = W x with independent non-Gaussian sources.
  2. Row-permute W so its diagonal is dominant (the Hungarian assignment,
     scipy's ``linear_sum_assignment`` on the host), scale rows to unit
     diagonal -> W'.
  3. B = I - W'; order the variables greedily by remaining in-mass (the
     closest strictly-lower-triangular form) -> causal order.
  4. Prune with the same OLS/adaptive-lasso machinery as DirectLiNGAM
     (:func:`repro_torch.core.pruning.estimate_adjacency`).

FastICA's starting rows come from a ``torch.Generator`` on the device
(another stream than ``jax.random``); ``w_init`` passes them explicitly.
The whitening matrix V diag(lambda^-1/2) V^T does not depend on the
eigenvectors' signs, and a row found as -w instead of w loses its sign in
the row scaling, so the estimate does not depend on either.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core import api, pruning


def _whiten(x):
    xc = x - x.mean(dim=0, keepdim=True)
    cov = (xc.T @ xc) / x.shape[0]
    vals, vecs = torch.linalg.eigh(cov)
    vals = torch.clamp(vals, min=1e-8)
    k = vecs @ torch.diag(vals**-0.5) @ vecs.T
    return xc @ k, k


def fastica(x, n_steps: int = 200, seed: int = 0, *, w_init=None,
            device="cuda"):
    """Deflation FastICA with logcosh nonlinearity. x: (m, d) -> W (d, d)
    as a numpy array (unmixing in whitened space composed with the
    whitening matrix). ``w_init``: a (d, d) array of starting rows; None
    draws them from ``seed`` on the device."""
    device = api.resolve_device(device)
    x = torch.tensor(np.asarray(x, np.float32), device=device)
    api._check_device(x)
    m, d = x.shape
    z, k = _whiten(x)
    if w_init is None:
        gen = torch.Generator(device=device).manual_seed(seed)
        w_init = torch.randn((d, d), generator=gen, device=device)
    else:
        w_init = torch.as_tensor(np.array(w_init, dtype=np.float32),
                                 device=device)
    w_done = torch.zeros((d, d), dtype=torch.float32, device=device)
    for i in range(d):
        w = w_init[i] / torch.linalg.norm(w_init[i])
        for _ in range(n_steps):
            g = torch.tanh(z @ w)
            gp = 1.0 - g * g
            w_new = (z.T @ g) / m - gp.mean() * w
            # Gram-Schmidt against the rows already extracted
            w_new = w_new - w_done.T @ (w_done @ w_new)
            w = w_new / torch.clamp(torch.linalg.norm(w_new), min=1e-9)
        w_done[i] = w
    return (w_done @ k.T).cpu().numpy()  # unmixing for raw (centered) x


def _permute_diag_dominant(w):
    """Hungarian assignment minimizing sum 1/|W_ii| (the standard
    ICA-LiNGAM row permutation, Shimizu et al. 2006 step 2)."""
    from scipy.optimize import linear_sum_assignment

    cost = 1.0 / np.maximum(np.abs(w), 1e-12)
    row_ind, col_ind = linear_sum_assignment(cost)
    perm = np.empty(w.shape[0], dtype=int)
    perm[col_ind] = row_ind
    return w[perm]


def _causal_order_from_b(b):
    """Greedy: repeatedly pick the row with smallest remaining in-mass."""
    d = b.shape[0]
    mass = np.abs(b).copy()
    remaining = list(range(d))
    order = []
    while remaining:
        sums = [mass[i, remaining].sum() for i in remaining]
        root = remaining[int(np.argmin(sums))]
        order.append(root)
        remaining.remove(root)
    return np.array(order)


@dataclasses.dataclass
class ICALiNGAM:
    n_steps: int = 200
    seed: int = 0
    prune_method: str = "ols"
    prune_threshold: float = 0.0
    device: str = "cuda"

    causal_order_: Optional[np.ndarray] = None
    adjacency_: Optional[np.ndarray] = None

    def fit(self, x, *, w_init=None) -> "ICALiNGAM":
        device = api.resolve_device(self.device)
        x = np.ascontiguousarray(x, dtype=np.float32)
        w = fastica(x, n_steps=self.n_steps, seed=self.seed, w_init=w_init,
                    device=device)
        wp = _permute_diag_dominant(w)
        wp = wp / np.diag(wp)[:, None]
        b = np.eye(x.shape[1]) - wp
        order = _causal_order_from_b(b)
        badj = pruning.estimate_adjacency(
            torch.tensor(x, device=device),
            torch.as_tensor(order, dtype=torch.long, device=device),
            method=self.prune_method, threshold=self.prune_threshold,
        )
        self.causal_order_ = order
        self.adjacency_ = badj.cpu().numpy()
        return self
