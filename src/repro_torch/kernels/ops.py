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
accumulation order. Every entry also takes a leading batch axis, x_std
(b, m, d) and c (b, d, d), as the reference's ``pairwise_moments`` does
(``repro/kernels/ops.py``): on the card one kernel launch over the batch
grid axis, with ``"ref"`` / ``"blocked"`` a loop over the elements.

The streaming entries return *sums*: ``pairwise_moment_sums_rows`` for a
row tile (kernel B2 on the card), ``pairwise_moment_sums_chunked`` over
(chunk, d) sample slabs (one B2 launch over all slabs, the slab sums
added in fixed order),
and ``fused_moment_rows`` from raw X (kernel B3). ``pairwise_moments_chunked``
divides the chunked sums by m.
"""

from __future__ import annotations

import numpy as np
import torch

from . import fused_stats, pairwise_stats, ref
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


def pairwise_moment_sums_blocked(x_std, c, row0: int = 0, rows: int = None,
                                 block: int = 64):
    """Row-blocked plain version of the moment *sums* of the row tile
    ``[row0, row0 + rows)``: O(block * d * m) peak memory.

    Loops over blocks of ``i`` rows; within a block the (block, d, m)
    residual tensor is formed and reduced.
    """
    m, d = x_std.shape
    rows = d - row0 if rows is None else rows
    block = min(block, _round_up(rows, 8))
    xt = x_std.T.float()
    c_rows = c[row0:row0 + rows].float()
    inv_std = torch.rsqrt(torch.clamp(1.0 - c_rows * c_rows, min=ref.EPS))
    s1 = torch.empty((rows, d), dtype=torch.float32, device=x_std.device)
    s2 = torch.empty_like(s1)
    for r0 in range(0, rows, block):
        r1 = min(rows, r0 + block)
        xi = xt[row0 + r0:row0 + r1, None, :]
        r = xi - c_rows[r0:r1, :, None] * xt[None]
        logcosh, uexp = nonlinear_terms(r * inv_std[r0:r1, :, None])
        s1[r0:r1] = logcosh.sum(dim=-1)
        s2[r0:r1] = uexp.sum(dim=-1)
    return s1, s2


def _each(fn, x_std, c):
    """``fn(x_std, c)``, looped over a leading batch axis if there is one."""
    if x_std.dim() == 3:
        return pairwise_stats.over_batch(fn, x_std, c)
    return fn(x_std, c)


def pairwise_moments_blocked(x_std, c, block: int = 64):
    """Row-blocked plain version of the means (M1, M2), each (d, d)."""
    inv_m = float(np.float32(1.0 / x_std.shape[0]))
    s1, s2 = pairwise_moment_sums_blocked(x_std, c, block=block)
    return s1 * inv_m, s2 * inv_m


def pairwise_moments(x_std, c, *, backend: str = None):
    """Dispatching wrapper. x_std: (m, d) standardized, c: (d, d); or
    x_std (b, m, d) and c (b, d, d), giving (b, d, d) moments."""
    check_backend(backend)
    if backend == "ref":
        return _each(ref.pairwise_moments_ref, x_std, c)
    if backend == "blocked":
        return _each(pairwise_moments_blocked, x_std, c)
    _check_on_card(backend, x_std)
    # The kernel reads both row-major; cuBLAS may return X^T X
    # column-major (no copy when already contiguous).
    return pairwise_stats.pairwise_moments(x_std.contiguous(), c.contiguous())


def _check_on_card(backend, x_std) -> None:
    if backend == "cuda" and not x_std.is_cuda:
        raise ValueError(
            f"backend 'cuda' needs tensors on a CUDA device, got "
            f"{x_std.device}; use backend=None or 'blocked' on the CPU"
        )


def _check_sums_backend(backend, x_std, what: str) -> None:
    """Raise on a backend the moment-*sums* entries do not run: an
    unknown one, ``"ref"``, or ``"cuda"`` on a tensor off the card."""
    check_backend(backend)
    if backend == "ref":
        raise ValueError(f"{what} have no 'ref' backend")
    _check_on_card(backend, x_std)


def _check_tile(d: int, row_start: int, tile: int) -> None:
    # A host-int tile: out of range raises (the reference's traced
    # dynamic_slice clamps instead; no caller passes one).
    if not (0 <= row_start and tile >= 1 and row_start + tile <= d):
        raise ValueError(
            f"row tile [{row_start}, {row_start + tile}) outside [0, {d})"
        )


def pairwise_moment_sums_rows(x_std, c, row_start: int, tile: int, *,
                              backend: str = None):
    """Pairwise residual moment *sums* (S1, S2), each (tile, d) float32,
    for the rows ``[row_start, row_start + tile)`` against all columns.

    ``x_std`` (m, d) is standardized by the statistics ``c`` came from;
    ``row_start`` is a host int. Backends as :func:`pairwise_moments`,
    without ``"ref"``.
    """
    _check_sums_backend(backend, x_std, "row-tile moment sums")
    _check_tile(x_std.shape[-1], row_start, tile)
    if backend == "blocked":
        return _each(lambda xk, ck: pairwise_moment_sums_blocked(
            xk, ck, row_start, tile), x_std, c)
    return pairwise_stats.pairwise_moment_sums_rows(
        x_std.contiguous(), c.contiguous(), row_start, tile)


def pairwise_moment_sums_chunked(x_std, c, *, chunk: int = 512,
                                 backend: str = None):
    """Pairwise residual moment *sums* (S1, S2), each (d, d), accumulated
    over (chunk, d) sample slabs, the slab sums added in fixed order in
    float32.

    The streaming entry. On the card (backend ``None`` or ``"cuda"``) it
    is one launch of kernel B2 over every slab
    (``pairwise_stats.pairwise_moment_sums_slabs``), equal bit for bit to
    one :func:`pairwise_moment_sums_rows` call per slab added in order,
    which is what its plain version does on the CPU. Each slab's split
    plan depends on the slab's sample count alone, so a pair's sums are
    the same at every buffer width. ``chunk`` bounds the residual
    intermediate of the plain versions at O(chunk * d^2).
    """
    _check_sums_backend(backend, x_std, "chunked moment sums")
    chunk = max(1, min(chunk, x_std.shape[-2]))
    x_std = x_std.contiguous()
    c = c.contiguous()
    if backend == "blocked":
        return pairwise_stats.sum_over_slabs(
            x_std, chunk,
            lambda xs: _each(pairwise_moment_sums_blocked, xs, c))
    return pairwise_stats.pairwise_moment_sums_slabs(x_std, c, chunk)


def pairwise_moments_chunked(x_std, c, *, chunk: int = 512,
                             backend: str = None):
    """Chunk-accumulated pairwise moment *means*: the chunked sums times
    the float32 1/m, as the reference."""
    inv_m = float(np.float32(1.0 / x_std.shape[-2]))
    s1, s2 = pairwise_moment_sums_chunked(x_std, c, chunk=chunk,
                                          backend=backend)
    return s1 * inv_m, s2 * inv_m


def fused_moment_rows(x_raw, mu, rstd, c, row_start: int, tile: int):
    """Fused standardize + moment *sums* (S1, S2), each (tile, d), for
    rows ``[row_start, row_start + tile)`` of *raw* sample-major data
    (float32 or bfloat16) with per-variable ``mu`` and ``rstd``.

    Kernel B3 on a CUDA tensor, its plain version on a CPU tensor. The
    samples are masked by index, so nothing is padded; ``row_start`` is
    a host int and a tile out of range raises.
    """
    return fused_stats.fused_moment_sums(
        x_raw.contiguous(), mu.float().contiguous(),
        rstd.float().contiguous(), c.float().contiguous(), row_start, tile)


def standardize(x, eps=ref.EPS):
    """(m, d) -> standardized columns, ddof=0 (matches Algorithm 1)."""
    return ref.standardize(x, axis=0, eps=eps)


def correlation(x_std):
    return ref.correlation(x_std)
