"""Stein Variational Gradient Descent (Liu & Wang, 2016) in PyTorch.

Used for the paper's section 4.1 evaluation: after DirectLiNGAM produces
the weighted adjacency, a Bayesian linear-SEM posterior is approximated
with SVGD particles and scored on held-out interventions (I-NLL / I-MAE).

    T(x) = x + eps * phi(x),
    phi(x) = E_{x'~q}[ k(x', x) grad_{x'} log p(x') + grad_{x'} k(x', x) ]

with an RBF kernel using the median heuristic. The JAX package's
``vi/svgd.py`` on the particles' device: the per-particle gradient by
``torch.func.vmap(torch.func.grad(logp))`` (particles are independent),
the steps a plain Python loop.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch


def _median(v):
    """Median of a flat tensor; for an even count the mean of the two
    middle values, ``(lo + hi) * 0.5`` as ``jnp.median`` computes it
    (``torch.median`` returns the lower one)."""
    s = torch.sort(v).values
    n = s.numel()
    return (s[(n - 1) // 2] + s[n // 2]) * 0.5


def _rbf(particles):
    """RBF kernel matrix + grad wrt first arg, median-heuristic bandwidth.
    particles: (n, d). Returns (K (n, n), dK (n, d)) where
    dK[i] = sum_j grad_{x_i} k(x_i, x_j)."""
    n = particles.shape[0]
    diff = particles[:, None, :] - particles[None, :, :]  # (n, n, d)
    sq = torch.sum(diff * diff, dim=-1)
    med = _median(sq.flatten())
    # log(n + 1) in float32, as the reference computes it.
    h = torch.sqrt(0.5 * med / float(np.log(np.float32(n + 1.0))) + 1e-8)
    k = torch.exp(-sq / (2 * h * h))
    # repulsion: sum_j grad_{x_j} k(x_j, x_i) = sum_j (x_i - x_j)/h^2 * k_ij
    dk = torch.einsum("ijd,ij->id", diff, k) / (h * h)
    return k, dk


def svgd(
    particles: torch.Tensor,
    logp: Callable[[torch.Tensor], torch.Tensor],
    n_steps: int = 500,
    step_size: float = 1e-2,
):
    """Run SVGD on the particles' device. particles: (n, d); logp maps
    (d,) -> scalar, written with torch operations."""
    grad_logp = torch.func.vmap(torch.func.grad(logp))
    parts = particles
    for _ in range(n_steps):
        g = grad_logp(parts)  # (n, d)
        k, dk = _rbf(parts)
        phi = (k @ g + dk) / parts.shape[0]
        parts = parts + step_size * phi
    return parts


def gaussian_sem_logp(b_adj, noise_scale, prior_scale=1.0):
    """log p(x) for the linear SEM x = B x + e with a weak Gaussian prior
    on latents: returns a callable for SVGD over a single sample vector x
    (on ``b_adj``'s device)."""
    d = b_adj.shape[0]
    eye = torch.eye(d, dtype=b_adj.dtype, device=b_adj.device)

    def logp(x):
        resid = (eye - b_adj) @ x
        ll = -0.5 * torch.sum((resid / noise_scale) ** 2)
        prior = -0.5 * torch.sum((x / prior_scale) ** 2)
        return ll + 1e-3 * prior

    return logp
