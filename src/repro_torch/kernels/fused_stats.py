"""CUDA kernel for the fused standardize + pairwise moment sums (B3).

The kernel (``csrc/fused_moments.cu``) replaces the Pallas TPU kernel
``repro.kernels.fused_stats._fused_kernel`` launched by
``fused_moment_sums``. It reads *raw* sample-major X, float32 or
bfloat16, in place and standardizes each value in registers as
``(x - mu[v]) * rstd[v]`` in float32 before the moment math of
:mod:`repro_torch.kernels.pairwise_stats`, so the standardized copy is
never written to device memory, and a bfloat16 X halves the bytes read.
It returns the moment *sums* of a row tile ``[row0, row0 + rows)``
against all columns, with B1's split plan and 128-wide sub-sums.

``fused_moment_sums_plain`` is its plain-torch version: upcast,
standardize, then ``pairwise_stats.pairwise_moment_sums_plain`` on the
row tile. The wrapper takes it only for tensors on the CPU; for a CUDA
tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build, pairwise_stats

# Kernel launches through ``fused_moment_sums`` (one per call on the card).
launches = 0


def _check(x_raw, mu, rstd, c, row0, rows):
    if x_raw.dim() != 2:
        raise ValueError(f"x_raw must be (m, d), got {tuple(x_raw.shape)}")
    m, d = x_raw.shape
    if tuple(mu.shape) != (d,) or tuple(rstd.shape) != (d,):
        raise ValueError(
            f"mu and rstd must be ({d},), got {tuple(mu.shape)} and "
            f"{tuple(rstd.shape)}"
        )
    if tuple(c.shape) != (d, d):
        raise ValueError(f"c must be ({d}, {d}), got {tuple(c.shape)}")
    if m < 1 or d < 1:
        raise ValueError(f"empty input of shape {(m, d)}")
    if not (0 <= row0 and rows >= 1 and row0 + rows <= d):
        raise ValueError(f"row tile [{row0}, {row0 + rows}) outside [0, {d})")
    if len({x_raw.device, mu.device, rstd.device, c.device}) != 1:
        raise ValueError("x_raw, mu, rstd and c must be on one device")


def fused_moment_sums_plain(x_raw, mu, rstd, c, *, row0=0, rows=None,
                            n_split=None):
    """Plain-torch version of the kernel: (S1, S2), each (rows, d).

    Computes in float64 when ``x_raw`` is float64 (the chip check's
    reference), else in float32, bfloat16 input upcast exactly.
    """
    d = x_raw.shape[1]
    rows = d - row0 if rows is None else rows
    _check(x_raw, mu, rstd, c, row0, rows)
    dtype = torch.float64 if x_raw.dtype == torch.float64 else torch.float32
    x_std = (x_raw.to(dtype) - mu.to(dtype)[None, :]) * rstd.to(dtype)[None, :]
    return pairwise_stats.pairwise_moment_sums_plain(
        x_std, c.to(dtype), row0=row0, rows=rows, n_split=n_split)


@functools.cache
def _kernel_lib():
    lib = build.load("fused_moments")
    lib.fused_moment_partials.restype = ctypes.c_int
    lib.fused_moment_partials.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ]
    lib.fused_moment_reduce.restype = ctypes.c_int
    lib.fused_moment_reduce.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p,
    ]
    return lib


def _launch(x_raw, mu, rstd, c, row0, rows, n_split):
    if x_raw.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(
            f"the CUDA kernel takes float32 or bfloat16 X, got {x_raw.dtype}"
        )
    if any(t.dtype != torch.float32 for t in (mu, rstd, c)):
        raise TypeError(
            f"the CUDA kernel takes float32 mu, rstd and c, got {mu.dtype}, "
            f"{rstd.dtype} and {c.dtype}"
        )
    if not all(t.is_contiguous() for t in (x_raw, mu, rstd, c)):
        raise ValueError("the CUDA kernel takes contiguous x_raw, mu, rstd, c")
    m, d = x_raw.shape
    n_split, per_split = pairwise_stats.split_plan(m, n_split)
    lib = _kernel_lib()
    with torch.cuda.device(x_raw.device):
        stream = torch.cuda.current_stream().cuda_stream
        part1 = torch.empty((n_split, rows, d), device=x_raw.device)
        part2 = torch.empty_like(part1)
        out1 = torch.empty((rows, d), device=x_raw.device)
        out2 = torch.empty_like(out1)
        err = lib.fused_moment_partials(
            x_raw.data_ptr(), int(x_raw.dtype == torch.bfloat16),
            mu.data_ptr(), rstd.data_ptr(), c.data_ptr(), part1.data_ptr(),
            part2.data_ptr(), m, d, row0, rows, per_split, n_split, stream,
        )
        if err:
            raise RuntimeError(f"fused_moment_partials: CUDA error {err}")
        err = lib.fused_moment_reduce(
            part1.data_ptr(), part2.data_ptr(), out1.data_ptr(),
            out2.data_ptr(), n_split, rows * d, stream,
        )
        if err:
            raise RuntimeError(f"fused_moment_reduce: CUDA error {err}")
    return out1, out2


def fused_moment_sums(x_raw, mu, rstd, c, row0, rows, *, n_split=None):
    """Moment *sums* (S1, S2), each (rows, d) float32, of the row tile
    ``[row0, row0 + rows)`` against all d columns, from raw X.

    Args:
      x_raw: (m, d) raw samples, sample-major, float32 or bfloat16.
      mu, rstd: (d,) float32 per-variable mean and 1/std.
      c:     (d, d) float32 correlation of the standardized data.
      row0, rows: the tile, host ints; a tile outside [0, d) raises.
    On a CUDA tensor this launches the kernel (or raises on a dtype,
    layout or shape it does not take); on a CPU tensor it runs the plain
    version.
    """
    global launches
    _check(x_raw, mu, rstd, c, row0, rows)
    if x_raw.is_cuda:
        out = _launch(x_raw, mu, rstd, c, row0, rows, n_split)
        launches += 1
        return out
    if x_raw.device.type != "cpu":
        raise ValueError(f"no fused-moment kernel for {x_raw.device}")
    return fused_moment_sums_plain(x_raw, mu, rstd, c, row0=row0, rows=rows,
                                   n_split=n_split)
