"""Public wrappers around the pairwise-statistics kernel.

``pairwise_moments(x_std, c, backend=...)`` dispatches between:

  * ``None``      -- the CUDA kernel on a CUDA tensor, the kernel's plain
                     version on a CPU tensor (never a silent fallback: a
                     CUDA tensor the kernel cannot take raises).
  * ``"cuda"``    -- the CUDA kernel; raises on a tensor off the card.
  * ``"ref"``     -- plain-torch oracle (materializes (d, d, m); small
                     shapes only).
  * ``"blocked"`` -- plain-torch row-blocked version: O(block * d * m)
                     peak memory.

All backends return (M1, M2) of shape (d, d) fp32 equal up to fp32
accumulation order.
"""

from __future__ import annotations

import torch

from . import pairwise_stats, ref
from .nonlinearity import nonlinear_terms

BACKENDS = (None, "cuda", "ref", "blocked")


def _round_up(x: int, k: int) -> int:
    return ((x + k - 1) // k) * k


def check_backend(backend) -> None:
    """Raise on a backend name this port does not have."""
    if backend == "pallas":
        raise ValueError(
            "backend 'pallas' is the TPU kernel of the JAX package; the "
            "port's kernel backend is 'cuda'"
        )
    if backend not in BACKENDS:
        raise ValueError(
            f"unknown backend {backend!r}; expected one of {BACKENDS}"
        )


def pairwise_moments_blocked(x_std, c, block: int = 64):
    """Row-blocked plain version: O(block * d * m) peak memory.

    Loops over blocks of ``i`` rows; within a block the (block, d, m)
    residual tensor is formed and reduced.
    """
    m, d = x_std.shape
    block = min(block, _round_up(d, 8))
    xt = x_std.T.float()
    c = c.float()
    inv_std = torch.rsqrt(torch.clamp(1.0 - c * c, min=ref.EPS))
    m1 = torch.empty((d, d), dtype=torch.float32, device=x_std.device)
    m2 = torch.empty_like(m1)
    for r0 in range(0, d, block):
        r1 = min(d, r0 + block)
        r = xt[r0:r1, None, :] - c[r0:r1, :, None] * xt[None, :, :]
        logcosh, uexp = nonlinear_terms(r * inv_std[r0:r1, :, None])
        m1[r0:r1] = logcosh.mean(dim=-1)
        m2[r0:r1] = uexp.mean(dim=-1)
    return m1, m2


def pairwise_moments(x_std, c, *, backend: str = None):
    """Dispatching wrapper. x_std: (m, d) standardized; c: (d, d)."""
    check_backend(backend)
    if backend == "ref":
        return ref.pairwise_moments_ref(x_std, c)
    if backend == "blocked":
        return pairwise_moments_blocked(x_std, c)
    if backend == "cuda" and not x_std.is_cuda:
        raise ValueError(
            f"backend 'cuda' needs tensors on a CUDA device, got "
            f"{x_std.device}; use backend=None or 'blocked' on the CPU"
        )
    # The kernel reads both row-major; cuBLAS may return X^T X
    # column-major (no copy when already contiguous).
    return pairwise_stats.pairwise_moments(x_std.contiguous(), c.contiguous())


def standardize(x, eps=ref.EPS):
    """(m, d) -> standardized columns, ddof=0 (matches Algorithm 1)."""
    return ref.standardize(x, axis=0, eps=eps)


def correlation(x_std):
    return ref.correlation(x_std)
