"""GOLEM (Ng et al., 2020) in PyTorch: Gaussian MLE structure learning
with soft acyclicity + sparsity penalties (discussed in paper section 2.4).

    min_W  L(W; X) + lam1 ||W||_1 + lam2 h(W)
    L = d/2 log sum_i ||x_i - W^T x||^2 - log |det(I - W)|   (GOLEM-EV)

The JAX package's ``baselines/golem.py`` on the fit's device: the
gradient by autograd, the same Adam loop as NOTEARS
(:func:`repro_torch.baselines.notears.adam`).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import api

from .notears import _h_acyc, abs_sum, adam, loss_grad


def _golem_loss(w, x, lam1, lam2):
    m, d = x.shape
    resid = x - x @ w
    likelihood = 0.5 * d * torch.log(torch.sum(resid * resid) / m)
    eye = torch.eye(d, dtype=w.dtype, device=w.device)
    _, logdet = torch.linalg.slogdet(eye - w)
    return likelihood - logdet + lam1 * abs_sum(w) + lam2 * _h_acyc(w)


def _fit(x, lam1, lam2, n_steps, lr=1e-2):
    d = x.shape[1]
    w0 = torch.zeros((d, d), dtype=torch.float32, device=x.device)
    return adam(lambda w: loss_grad(_golem_loss, w, x, lam1, lam2), w0,
                n_steps, lr)


def golem_fit(x, lam1=2e-2, lam2=5.0, n_steps=3000, w_threshold=0.3,
              device="cuda"):
    """Thresholded adjacency, B[i, j] convention, as a numpy array. Runs
    on ``device``: the card unless the caller asks for ``"cpu"``."""
    device = api.resolve_device(device)
    x = torch.tensor(np.asarray(x, np.float32), device=device)
    api._check_device(x)
    x = x - x.mean(dim=0, keepdim=True)
    w = _fit(x, lam1, lam2, n_steps).cpu().numpy()
    w[np.abs(w) < w_threshold] = 0.0
    return w.T  # B[i, j] convention
