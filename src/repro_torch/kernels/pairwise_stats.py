"""CUDA kernel for the LiNGAM pairwise residual-entropy moments.

This is the paper's compute hot-spot (96% of DirectLiNGAM wall-clock):
for every ordered variable pair (i, j) compute the two nonlinear moments
of the standardized regression residual

    u_ij    = (x_i - C_ij * x_j) * rsqrt(1 - C_ij^2)
    M1[i,j] = E_s[log cosh u_ij]
    M2[i,j] = E_s[u_ij * exp(-u_ij^2 / 2)]

The kernel (``csrc/pairwise_moments.cu``, integrands in
``csrc/moment_terms.cuh``) replaces the Pallas TPU kernel
``repro.kernels.pairwise_stats._kernel``. It produces moment *sums* for a
row tile ``[row0, row0 + rows)`` against all columns over a sample axis
cut into slabs (:class:`SlabPlan`), each slab into the splits of
``split_plan(slab length)``; a second kernel adds each slab's splits in
fixed order, then the slab sums in slab order, so results are
bit-identical from run to run and at every tile shape. A launch's pair-
block edge T is its plan's: the ``plan`` a caller passes, else the one
``tune.dispatch`` gives (:func:`tile_for` is the heuristic). Three
wrappers share the launcher:

  * ``pairwise_moments`` -- the reference's ``pairwise_moments_pallas``
    (kernel B1): all d rows, one slab, divided by m in the reduce kernel;
  * ``pairwise_moment_sums_rows`` -- the reference's
    ``pairwise_moment_sums_rows`` (kernel B2): the *sums* of a row tile
    over one slab, scale 1;
  * ``pairwise_moment_sums_slabs`` -- B2 over (slab, d) sample slabs in
    one launch: the chunked streaming path
    (``ops.pairwise_moment_sums_chunked``), once per ordering step. It
    equals the per-slab ``pairwise_moment_sums_rows`` sums added in slab
    order, bit for bit.

Every wrapper also takes a leading batch axis, x_std (b, m, d) and c
(b, d, d), every element with the same m, d, row tile and slab plan: one
launch over a batch grid axis, the axis the TPU kernel gets under
``vmap``, for the bootstrap and many-dataset fits. Element k's sums equal
those of the launch on x_std[k] alone, bit for bit; a 2-D input is the
batch of one.

With telemetry on, each wrapper's computation (the launch on the card,
the plain version on the CPU) is a ``kernels.moments`` span with the
wrapper's ``op``, the ``shape`` (b, m, d), the ``rows`` of the tile and
the pair-block ``tile`` (None on the CPU); the launch plan's decision
before it is its sibling ``kernels.dispatch``.

``pairwise_moment_sums_plain`` is the kernel's plain-torch version: the
same split plan, the same 128-wide sample sub-sums, the same fixed order
of splits (the slab wrapper's plain version adds it slab by slab), and
over a batch a loop of the same over its elements. The wrappers take it
only for tensors on the CPU; for a CUDA tensor they launch the kernel or
raise.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import numpy as np
import torch

from repro_torch.obs import trace as obs_trace

from . import build
from .nonlinearity import nonlinear_terms

EPS = 1e-12
ACCUM_CHUNK = 128  # samples per sub-sum, as in the reference
# Sample splits per slab. With the 5 blocks of 128 threads that hold the
# 625 4x4 pair blocks of d = 100, the 127 splits of m = 1e6 give 635
# blocks, about 4.8 per SM of a 132-SM H100.
N_SPLIT = 128
TILES = (4, 2, 1)  # pair-block edges the kernel is built for
# The tile choice asks for this many threads per SM over the whole grid
# (8 warps) before it takes a larger pair block: of the thresholds that
# ``tile_sweep`` times on an H100 over the fit paths' widths, the one with
# the least time over all of them. A larger block wins at full width; a
# narrow stage with few pairs leaves SMs idle behind it (at width 8 and
# m = 1e6, 4 x 4 blocks take 8x the time of 1 x 1).
FILL_THREADS_PER_SM = 256
H100_SMS = 132
# Bytes of the two shared-memory stage buffers a block aims to stay under:
# three blocks of the 4x4 instance (167 registers a thread) fit an SM.
STAGE_BYTES = 64 * 1024
# Elements of one (rows, d, samples) temporary in the plain version.
_PLAIN_BUDGET = 1 << 22

# Kernel launches through each wrapper (one per call that runs on the card,
# a batched call included): ``launches`` counts pairwise_moments (B1),
# ``rows_launches`` pairwise_moment_sums_rows and pairwise_moment_sums_slabs
# (B2).
launches = 0
rows_launches = 0


def split_plan(m: int, n_split: int = None):
    """(n_split, chunks_per_split) for the split-m grid.

    A function of the sample count alone (``N_SPLIT`` splits by default),
    each split a whole number of 128-sample chunks, none of them empty;
    an explicit ``n_split`` is clamped the same way. It does not depend
    on the number of variables, so a pair's sums are bit-identical at
    every buffer width: the staged-compaction ordering then sees the
    same moments as the masked scan and returns the same order.
    """
    chunks = max(1, math.ceil(m / ACCUM_CHUNK))
    if n_split is None:
        n_split = N_SPLIT
    n_split = max(1, min(int(n_split), chunks))
    per_split = math.ceil(chunks / n_split)
    return math.ceil(chunks / per_split), per_split


@dataclasses.dataclass(frozen=True)
class SlabPlan:
    """The kernel's sample axis: ``n_full`` slabs of ``slab`` samples,
    then a ragged slab of ``tail`` samples (none when 0), each cut into
    ``split_plan(its length)`` splits. Grid index z walks the full slabs'
    splits in order, then the tail's."""

    slab: int
    n_full: int
    full_splits: int
    full_per: int
    tail: int
    tail_splits: int
    tail_per: int

    @property
    def n_z(self) -> int:
        """Splits over all slabs: the grid's sample extent."""
        return self.n_full * self.full_splits + self.tail_splits

    def ranges(self):
        """[(slab index, first sample, end sample)] for z = 0, 1, ...:
        the kernel's own decoding of z, for the tests."""
        out = []
        for z in range(self.n_z):
            if z < self.n_full * self.full_splits:
                slab, k = divmod(z, self.full_splits)
                base, length, per = slab * self.slab, self.slab, self.full_per
            else:
                slab, k = self.n_full, z - self.n_full * self.full_splits
                base, length, per = slab * self.slab, self.tail, self.tail_per
            begin = base + k * per * ACCUM_CHUNK
            out.append((slab, begin,
                        min(begin + per * ACCUM_CHUNK, base + length)))
        return out


def slab_plan(m: int, slab: int = None, n_split: int = None) -> SlabPlan:
    """Cut m samples into slabs of ``slab`` (all of m by default), the
    last one ragged, each slab split by :func:`split_plan` of its own
    length (``n_split`` passed on)."""
    slab = m if slab is None else max(1, min(int(slab), m))
    n_full, tail = divmod(m, slab)
    full_splits, full_per = split_plan(slab, n_split)
    tail_splits, tail_per = split_plan(tail, n_split) if tail else (0, 0)
    return SlabPlan(slab, n_full, full_splits, full_per, tail, tail_splits,
                    tail_per)


def tile_for(rows: int, d: int, n_z: int, sms: int = H100_SMS,
             fill: int = None) -> int:
    """The heuristic pair-block edge T of a launch (the dispatcher's plan
    when the tuning table has none): the largest of ``TILES`` whose pair
    blocks over all ``n_z`` splits (of every batch element: b x n_z for
    a batch) give every SM at least ``fill`` (``FILL_THREADS_PER_SM``)
    threads. T does not change a pair's sums."""
    fill = FILL_THREADS_PER_SM if fill is None else fill
    for t in TILES[:-1]:
        blocks = math.ceil(rows / t) * math.ceil(d / t)
        if blocks * n_z >= sms * fill:
            return t
    return TILES[-1]


def stage_for(d: int) -> int:
    """Samples per shared-memory stage: the largest divisor of 128 up to
    32 whose two buffers of rows (padded to 4 floats) fit STAGE_BYTES."""
    ld = -(-d // 4) * 4
    for n in (32, 16, 8, 4, 2):
        if 2 * n * ld * 4 <= STAGE_BYTES:
            return n
    return 1


def _check(x_std, c, row0, rows):
    if x_std.dim() not in (2, 3) or c.dim() != x_std.dim():
        raise ValueError(
            f"x_std must be (m, d) and c (d, d), or (b, m, d) and (b, d, d); "
            f"got {tuple(x_std.shape)} and {tuple(c.shape)}"
        )
    m, d = x_std.shape[-2:]
    if tuple(c.shape) != (*x_std.shape[:-2], d, d):
        raise ValueError(f"c must be {(*x_std.shape[:-2], d, d)}, got "
                         f"{tuple(c.shape)}")
    if m < 1 or d < 1:
        raise ValueError(f"empty input of shape {(m, d)}")
    if not (0 <= row0 and rows >= 1 and row0 + rows <= d):
        raise ValueError(f"row tile [{row0}, {row0 + rows}) outside [0, {d})")
    if x_std.device != c.device:
        raise ValueError(f"x_std on {x_std.device} but c on {c.device}")


def over_batch(fn, x_std, c):
    """``fn(x_std[k], c[k])`` for each element of a batch, its pairs of
    results stacked: the plain versions' loop over a leading batch axis."""
    out = [fn(xk, ck) for xk, ck in zip(x_std, c)]
    return tuple(torch.stack(parts) for parts in zip(*out))


def pairwise_moment_sums_plain(x_std, c, *, row0=0, rows=None, n_split=None):
    """Plain-torch version of the kernel: moment sums (S1, S2), each
    (rows, d), with the kernel's split plan and 128-wide sub-sums; over a
    leading batch axis, (b, rows, d) by a loop over the elements.

    Computes in ``x_std``'s dtype (the chip check runs it in float64);
    the row blocks keep each temporary under ``_PLAIN_BUDGET`` elements.
    """
    m, d = x_std.shape[-2:]
    rows = d - row0 if rows is None else rows
    _check(x_std, c, row0, rows)
    if x_std.dim() == 3:
        return over_batch(lambda xk, ck: pairwise_moment_sums_plain(
            xk, ck, row0=row0, rows=rows, n_split=n_split), x_std, c)
    n_split, per_split = split_plan(m, n_split)
    span = per_split * ACCUM_CHUNK
    xt = x_std.T
    c_rows = c[row0:row0 + rows].to(x_std.dtype)
    inv = torch.rsqrt(torch.clamp(1.0 - c_rows * c_rows, min=EPS))
    parts1 = x_std.new_zeros((n_split, rows, d))
    parts2 = x_std.new_zeros((n_split, rows, d))
    for k in range(n_split):
        xs = xt[:, k * span:min(m, (k + 1) * span)]  # (d, L)
        length = xs.shape[1]
        pad = (-length) % ACCUM_CHUNK
        block = max(1, _PLAIN_BUDGET // (d * (length + pad)))
        for r0 in range(0, rows, block):
            r1 = min(rows, r0 + block)
            xi = xs[row0 + r0:row0 + r1]
            u = (xi[:, None, :] - c_rows[r0:r1, :, None] * xs[None]) * (
                inv[r0:r1, :, None]
            )
            for parts, term in zip((parts1, parts2), nonlinear_terms(u)):
                # Zero terms pad the ragged last chunk: they add exactly 0.
                term = torch.nn.functional.pad(term, (0, pad))
                sub = term.reshape(r1 - r0, d, -1, ACCUM_CHUNK).sum(-1)
                parts[k, r0:r1] = sub.sum(-1)
    s1, s2 = parts1[0], parts2[0]
    for k in range(1, n_split):  # fixed order, as the reduce kernel
        s1 = s1 + parts1[k]
        s2 = s2 + parts2[k]
    return s1, s2


@functools.cache
def _kernel_lib():
    lib = build.load("pairwise_moments")
    lib.pairwise_moment_partials.restype = ctypes.c_int
    lib.pairwise_moment_partials.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.pairwise_moment_reduce.restype = ctypes.c_int
    lib.pairwise_moment_reduce.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
    ]
    return lib


MAX_BATCH = 65535  # the grid's y extent


def _launch_sums(x_std, c, row0, rows, slabs, scale, tile):
    """One launch of the partials kernel, with pair blocks of edge
    ``tile``, and one of the reduce kernel over x_std (m, d) or a batch
    (b, m, d) cut by the :class:`SlabPlan` ``slabs``; sums of shape
    (rows, d) or (b, rows, d)."""
    if tile not in TILES:
        raise ValueError(f"pair-block edge {tile} not in {TILES}")
    if x_std.dtype != torch.float32 or c.dtype != torch.float32:
        raise TypeError(
            f"the CUDA kernel takes float32, got {x_std.dtype} and {c.dtype}"
        )
    if not (x_std.is_contiguous() and c.is_contiguous()):
        raise ValueError("the CUDA kernel takes contiguous x_std and c")
    lead = x_std.shape[:-2]  # () or (b,)
    b = x_std.shape[0] if lead else 1
    if not 1 <= b <= MAX_BATCH:
        raise ValueError(f"batch of {b} outside [1, {MAX_BATCH}]")
    d = x_std.shape[-1]
    lib = _kernel_lib()
    with torch.cuda.device(x_std.device):
        stream = torch.cuda.current_stream().cuda_stream
        part1 = torch.empty((b, slabs.n_z, rows, d), device=x_std.device)
        part2 = torch.empty_like(part1)
        out1 = torch.empty((*lead, rows, d), device=x_std.device)
        out2 = torch.empty_like(out1)
        err = lib.pairwise_moment_partials(
            x_std.data_ptr(), c.data_ptr(), part1.data_ptr(),
            part2.data_ptr(), d, row0, rows, slabs.slab, slabs.n_full,
            slabs.full_splits, slabs.full_per, slabs.tail, slabs.tail_splits,
            slabs.tail_per, tile, stage_for(d), b, stream,
        )
        if err:
            raise RuntimeError(f"pairwise_moment_partials: CUDA error {err}")
        err = lib.pairwise_moment_reduce(
            part1.data_ptr(), part2.data_ptr(), out1.data_ptr(),
            out2.data_ptr(), rows * d, slabs.n_full, slabs.full_splits,
            slabs.tail_splits, scale, b, stream,
        )
        if err:
            raise RuntimeError(f"pairwise_moment_reduce: CUDA error {err}")
    return out1, out2


def _plan_tile(op, shape, x_std, tune, plan, chunk=None) -> int:
    """The pair-block edge of a launch: ``plan``'s, or else the one
    ``tune.dispatch`` gives for this shape, batch and card in mode
    ``tune``."""
    if plan is None:
        from .tune import registry

        plan = registry.dispatch(
            op, shape, mode=tune, chunk=chunk,
            batch=x_std.shape[0] if x_std.dim() == 3 else 1,
            device=x_std.device)
    return plan.tile


def _moments_span(op, x_std, rows, tile=None):
    """The ``kernels.moments`` span of one wrapper call; its attributes
    are built only when telemetry is on."""
    if not obs_trace.enabled():
        return obs_trace.span("kernels.moments")
    m, d = x_std.shape[-2:]
    b = x_std.shape[0] if x_std.dim() == 3 else 1
    return obs_trace.span("kernels.moments", op=op, shape=(b, m, d),
                          rows=rows, tile=tile)


def pairwise_moments(x_std, c, *, n_split=None, tune="cache", plan=None):
    """Pairwise residual moments (M1, M2), each (d, d) float32 means.

    Args:
      x_std: (m, d) standardized samples, sample-major; or a batch
             (b, m, d), giving (b, d, d) moments in one launch.
      c:     (d, d) sample correlation of ``x_std`` (full fp32), or
             (b, d, d).
      tune, plan: the launch plan (its pair-block edge): ``plan`` if
             given, else the dispatcher's in mode ``tune``.
    On a CUDA tensor this launches the kernel (float32, contiguous, or it
    raises); on a CPU tensor it runs the plain version.
    """
    global launches
    m, d = x_std.shape[-2:]
    _check(x_std, c, 0, d)
    inv_m = float(np.float32(1.0 / m))  # the reference's f32 1/m
    if x_std.is_cuda:
        tile = _plan_tile("pairwise_moments", (m, d), x_std, tune, plan)
        with _moments_span("pairwise_moments", x_std, d, tile):
            out = _launch_sums(x_std, c, 0, d, slab_plan(m, n_split=n_split),
                               inv_m, tile)
        launches += 1
        return out
    if x_std.device.type != "cpu":
        raise ValueError(f"no pairwise-moment kernel for {x_std.device}")
    with _moments_span("pairwise_moments", x_std, d):
        s1, s2 = pairwise_moment_sums_plain(x_std, c, n_split=n_split)
        return s1 * inv_m, s2 * inv_m


def pairwise_moment_sums_rows(x_std, c, row0, rows, *, n_split=None,
                              tune="cache", plan=None):
    """Pairwise residual moment *sums* (S1, S2), each (rows, d) float32,
    for the row tile ``[row0, row0 + rows)`` against all d columns.

    Args:
      x_std: (m, d) standardized samples, sample-major (a row slice of a
             larger sample-major X is a valid, contiguous input); or a
             batch (b, m, d), giving (b, rows, d) sums.
      c:     (d, d) correlation of the data ``x_std`` was standardized by,
             or (b, d, d).
      row0, rows: the tile, host ints; a tile outside [0, d) raises.
      tune, plan: the launch plan, as :func:`pairwise_moments`.
    On a CUDA tensor this launches the kernel (float32, contiguous, or it
    raises); on a CPU tensor it runs the plain version.
    """
    global rows_launches
    _check(x_std, c, row0, rows)
    if x_std.is_cuda:
        m, d = x_std.shape[-2:]
        tile = _plan_tile("pairwise_moment_sums_rows", (rows, d, m), x_std,
                          tune, plan)
        with _moments_span("pairwise_moment_sums_rows", x_std, rows, tile):
            out = _launch_sums(x_std, c, row0, rows,
                               slab_plan(m, n_split=n_split), 1.0, tile)
        rows_launches += 1
        return out
    if x_std.device.type != "cpu":
        raise ValueError(f"no pairwise-moment kernel for {x_std.device}")
    with _moments_span("pairwise_moment_sums_rows", x_std, rows):
        return pairwise_moment_sums_plain(x_std, c, row0=row0, rows=rows,
                                          n_split=n_split)


def pairwise_moment_sums_slabs(x_std, c, slab, *, row0=0, rows=None,
                               tune="cache", plan=None):
    """Pairwise residual moment *sums* (S1, S2), each (rows, d) float32,
    of the row tile ``[row0, row0 + rows)``, over (slab, d) sample slabs
    of ``x_std`` (the last one ragged): the slab sums of
    :func:`pairwise_moment_sums_rows`, added in slab order.

    On a CUDA tensor this is one launch of the kernel (float32,
    contiguous, or it raises) over every slab's splits, of every element
    of a leading batch axis if there is one, equal bit for bit to the
    per-slab launches added in order; on a CPU tensor it runs the plain
    version slab by slab. ``tune`` and ``plan`` give the launch plan, as
    :func:`pairwise_moments`.
    """
    global rows_launches
    m, d = x_std.shape[-2:]
    rows = d - row0 if rows is None else rows
    _check(x_std, c, row0, rows)
    slabs = slab_plan(m, slab)
    if x_std.is_cuda:
        tile = _plan_tile("pairwise_moment_sums_chunked", (m, d), x_std,
                          tune, plan, chunk=slabs.slab)
        with _moments_span("pairwise_moment_sums_slabs", x_std, rows, tile):
            out = _launch_sums(x_std, c, row0, rows, slabs, 1.0, tile)
        rows_launches += 1
        return out
    if x_std.device.type != "cpu":
        raise ValueError(f"no pairwise-moment kernel for {x_std.device}")
    with _moments_span("pairwise_moment_sums_slabs", x_std, rows):
        return sum_over_slabs(x_std, slabs.slab, lambda xs: (
            pairwise_moment_sums_plain(xs, c, row0=row0, rows=rows)))


def sum_over_slabs(x_std, slab, sums):
    """``sums(slab of x_std)`` over the (slab, d) sample slabs of ``x_std``
    (the last one ragged; the sample axis is the second to last), added in
    slab order: the order in which the slab-structured launch adds its
    slab sums."""
    s1, s2 = sums(x_std[..., :slab, :])
    for k0 in range(slab, x_std.shape[-2], slab):
        t1, t2 = sums(x_std[..., k0:k0 + slab, :])
        s1 = s1 + t1
        s2 = s2 + t2
    return s1, s2
