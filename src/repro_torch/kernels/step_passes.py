"""CUDA kernels for the ordering step's column passes and its root.

One DirectLiNGAM ordering step (:mod:`repro_torch.core.ordering`)
standardizes the working buffer, forms its correlation and column moments,
scores the columns from those and kernel B1's pair moments, and regresses
the other columns on the chosen root. Composed from PyTorch ops the
column passes are ~70 launches and ~90 passes over the buffer's bytes a
step (a float64 copy of it for the Gram product among them), the scores
and the root ~30 launches. The kernels of ``csrc/step_passes.cu`` do the
same work in six launches and one or two:

  * :func:`standardize` -- each column's float64 mean and centred sum of
    squares (a two-pass mean and variance within each 32-sample slab, the
    slabs and then the splits merged in a fixed order by Chan's formula),
    float32 ``x_std = (x - mu) * rsqrt(var)`` together with the column
    moments E log cosh x_std and E x_std exp(-x_std^2 / 2) (float64 sums
    of B1's integrand), and C = x_std^T x_std / m, its sums in float64 on
    the FP64 tensor cores, rounded to float32;
  * :func:`residualize` -- ``x_j - coef_j x_root`` on every column but the
    root, the root's covariances taken from the step's float64 Gram sums,
    written into a buffer one column narrower (the root's column left
    out), with the columns' labels and the root's place in the order: the
    next step runs at the active width;
  * :func:`scores_root` -- the step's scores and root from the column
    moments and B1's pair moments, every column active: each float32 term
    of the composed ``step_scores`` bit for bit, the float64 row sums, the
    first maximum.

The kernels replace no Pallas kernel: the JAX step is plain ``jnp``. The
column passes are bound by bytes, about six passes over the buffer a step
(four reads, two writes), but for the Gram product, bound by the FP64
tensor cores; the scores by their launches; the source's header says what
the design does about each.
Every sum runs over the samples in an order fixed by m alone (the splits
of :func:`split_plan`), never by the width, the column's position, the
batch or the tile, so a column's statistics, moments and C entries are the
same bits in every layout: the ordering compacted at every step keeps the
masked scan's order, and a batch element the single fit's.

:func:`standardize` and :func:`residualize` take a leading batch axis,
x (b, m, w), and raise on a tensor off the card: the plain versions are the
composed functions of :mod:`repro_torch.core.ordering`
(``step_standardize``, ``compact_residualize``) and
:func:`repro_torch.core.measures.nonlinear_moments`, which the ordering
takes for a CPU tensor. :func:`scores_root` takes the batch too, and runs
its plain version, ``ordering.step_scores`` and ``torch.argmax``, on a
CPU tensor; it raises on any other device.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import build

SLAB = 32  # samples a slab: the unit of the two-pass statistics
# (most splits, fewest slabs a split) of the column passes and of the Gram
# sums; at m = 1e6, 505 and 128 splits; at m = 3999, 16 and 4.
COL_SPLITS = (512, 8)
GRAM_SPLITS = (128, 32)
RESID_ROWS = 64  # samples a block of the residual update
MAX_BATCH = 65535  # the grid's y extent

SCORE_TILE = 32  # score tile edge (the kernels' kScoreTile)

# Calls that ran on the card: one per standardize (five kernel launches),
# one per residualize (one launch), one per scores_root (one launch up to
# 64 columns, two past).
launches = 0
residualize_launches = 0
scores_launches = 0


def split_plan(m: int, max_splits: int, min_slabs: int):
    """(n_split, slabs_per_split) over ceil(m / SLAB) slabs: at most
    ``max_splits`` splits of at least ``min_slabs`` slabs (fewer when m is
    small), the last one ragged. A function of m alone."""
    slabs = max(1, math.ceil(m / SLAB))
    n = max(1, min(max_splits, math.ceil(slabs / min_slabs)))
    per = math.ceil(slabs / n)
    return math.ceil(slabs / per), per


@functools.cache
def _lib():
    lib = build.load("step_passes")
    lib.step_standardize.restype = ctypes.c_int
    lib.step_standardize.argtypes = [ctypes.c_void_p] * 14 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.step_residualize.restype = ctypes.c_int
    lib.step_residualize.argtypes = [ctypes.c_void_p] * 8 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.step_scores_root.restype = ctypes.c_int
    lib.step_scores_root.argtypes = [ctypes.c_void_p] * 7 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
        ctypes.c_float, ctypes.c_float, ctypes.c_void_p,
    ]
    return lib


@functools.cache
def _entropy_constants():
    """(H_gauss, K1, K2, gamma) of ``measures.entropy_from_moments`` as
    float32, as the composed function's scalar operands round them."""
    from repro_torch.core import measures

    return tuple(float(torch.tensor(v, dtype=torch.float32)) for v in (
        measures._H_GAUSS, measures.K1, measures.K2, measures.GAMMA))


def _check(x):
    if not x.is_cuda:
        raise ValueError(f"the step-pass kernels run on the card, not on "
                         f"{x.device}")
    if x.dim() not in (2, 3) or x.shape[-2] < 1 or x.shape[-1] < 1:
        raise ValueError(f"x must be (m, w) or (b, m, w), got "
                         f"{tuple(x.shape)}")
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise TypeError(f"the step-pass kernels take contiguous float32, got "
                        f"{x.dtype}, contiguous={x.is_contiguous()}")
    b = x.shape[0] if x.dim() == 3 else 1
    if not 1 <= b <= MAX_BATCH:
        raise ValueError(f"batch of {b} outside [1, {MAX_BATCH}]")
    return b


def standardize(x):
    """One step's standardization on the card.

    Args:
      x: (m, w) working data, sample-major float32, or a batch (b, m, w).
    Returns:
      (x_std, c, mu, var, (cm1, cm2), gram): float32 x_std like x; the
      float32 correlation c (..., w, w); float32 means and variances
      (clamped at 1e-12) (..., w); the float32 column moments (..., w);
      the float64 E[x_std_i x_std_j] (..., w, w) that c rounds.
    """
    global launches
    b = _check(x)
    lead = x.shape[:-2]
    m, w = x.shape[-2:]
    col_splits, col_per = split_plan(m, *COL_SPLITS)
    gram_splits, gram_per = split_plan(m, *GRAM_SPLITS)
    dev = x.device
    x_std = torch.empty_like(x)
    mu, var, rstd, cm1, cm2 = torch.empty((5, *lead, w), device=dev)
    gram = torch.empty((*lead, w, w), dtype=torch.float64, device=dev)
    c = torch.empty((*lead, w, w), device=dev)
    parts = torch.empty((4, b, col_splits, w), dtype=torch.float64,
                        device=dev)
    gram_part = torch.empty((b, gram_splits, w, w), dtype=torch.float64,
                            device=dev)
    with torch.cuda.device(dev):
        err = _lib().step_standardize(
            x.data_ptr(), x_std.data_ptr(), mu.data_ptr(), var.data_ptr(),
            rstd.data_ptr(), cm1.data_ptr(), cm2.data_ptr(), gram.data_ptr(),
            c.data_ptr(), *(p.data_ptr() for p in parts),
            gram_part.data_ptr(), m, w, col_splits, col_per, gram_splits,
            gram_per, b, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"step_standardize: CUDA error {err}")
    launches += 1
    return x_std, c, mu, var, (cm1, cm2), gram


def residualize(x, root, gram, var, labels, order, k):
    """The residual update on the card, compacting the buffer: every
    column but ``root`` regressed on ``root``'s column of ``x``,
    coefficient ``gram[root, j] * sqrt(var[j] / var[root])``, written at
    column ``j - (j > root)`` of a buffer one column narrower.

    Args:
      x:      (m, w) float32 working data, or (b, m, w); w >= 2.
      root:   0-d or (b,) int64 device tensor, an index into the w columns.
      gram, var: the step's :func:`standardize` results for ``x``.
      labels: (w,) or (b, w) int64, each column's original index.
      order:  (d,) or (b, d) int64, the order being built: the launch
              writes ``labels[root]`` at position ``k`` and, when w = 2,
              the surviving label at ``k + 1``.
    Returns:
      (x_new, labels_new): (..., m, w - 1) and (..., w - 1), the root's
      column and label left out, the others in their order.
    """
    global residualize_launches
    b = _check(x)
    lead = x.shape[:-2]
    m, w = x.shape[-2:]
    if w < 2:
        raise ValueError(f"the residual update needs w >= 2, got {w}")
    if (root.dtype != torch.int64 or tuple(root.shape) != tuple(lead)
            or root.device != x.device):
        raise ValueError(f"root must be int64 {tuple(lead)}, got "
                         f"{root.dtype} {tuple(root.shape)}")
    if (gram.dtype != torch.float64 or tuple(gram.shape) != (*lead, w, w)
            or var.dtype != torch.float32 or tuple(var.shape) != (*lead, w)
            or not (gram.is_contiguous() and var.is_contiguous())
            or gram.device != x.device or var.device != x.device):
        raise ValueError("gram and var must be standardize's results for x")
    d = order.shape[-1]
    if (labels.dtype != torch.int64 or tuple(labels.shape) != (*lead, w)
            or not labels.is_contiguous() or labels.device != x.device
            or order.dtype != torch.int64 or tuple(order.shape) != (*lead, d)
            or not order.is_contiguous() or order.device != x.device
            or not 0 <= k <= d - w):
        raise ValueError(f"labels must be int64 {(*lead, w)} and order int64 "
                         f"{(*lead, d)} with room for step {k}")
    root = root.contiguous()
    x_new = torch.empty((*lead, m, w - 1), device=x.device)
    labels_new = torch.empty((*lead, w - 1), dtype=torch.int64,
                             device=x.device)
    with torch.cuda.device(x.device):
        err = _lib().step_residualize(
            x.data_ptr(), root.data_ptr(), gram.data_ptr(), var.data_ptr(),
            labels.data_ptr(), x_new.data_ptr(), labels_new.data_ptr(),
            order.data_ptr(), m, w, d, k, RESID_ROWS, b,
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"step_residualize: CUDA error {err}")
    residualize_launches += 1
    return x_new, labels_new


def scores_root(cm1, cm2, m1, m2):
    """The step's scores and root, every column active.

    Args:
      cm1, cm2: (w,) or (b, w) float32 column moments (``standardize``'s).
      m1, m2:   (w, w) or (b, w, w) float32 pair moments (kernel B1's).
    Returns:
      (root, k_list): the first maximum of k_list, a 0-d or (b,) int64
      device tensor, and the (..., w) float64 scores of
      ``ordering.step_scores`` with every column active. On the card
      each float32 term is the composed one's bits and a row's terms are
      summed in an order fixed by w; on a CPU tensor it runs the composed
      function and ``torch.argmax``.
    """
    global scores_launches
    if not m1.is_cuda:
        if m1.device.type != "cpu":
            raise ValueError(f"no score kernel for {m1.device}")
        from repro_torch.core import ordering

        active = torch.ones(cm1.shape, dtype=torch.bool, device=m1.device)
        k_list = ordering.step_scores(cm1, cm2, m1, m2, active)
        return torch.argmax(k_list, dim=-1), k_list
    lead, w = cm1.shape[:-1], cm1.shape[-1]
    b = lead[0] if lead else 1
    if (len(lead) > 1 or w < 1 or not 1 <= b <= MAX_BATCH
            or tuple(cm2.shape) != (*lead, w)
            or tuple(m1.shape) != (*lead, w, w)
            or tuple(m2.shape) != (*lead, w, w)):
        raise ValueError(f"column moments (..., w) and pair moments (..., w, "
                         f"w) with at most one batch axis, got "
                         f"{tuple(cm1.shape)}, {tuple(cm2.shape)}, "
                         f"{tuple(m1.shape)}, {tuple(m2.shape)}")
    ins = (cm1, cm2, m1, m2)
    if any(t.dtype != torch.float32 or not t.is_contiguous()
           or t.device != m1.device for t in ins):
        raise TypeError("the score kernel takes contiguous float32 moments "
                        "on one device")
    dev = m1.device
    nt = -(-w // SCORE_TILE)
    part = torch.empty((b, nt, w), dtype=torch.float64, device=dev)
    k_list = torch.empty((*lead, w), dtype=torch.float64, device=dev)
    root = torch.empty(lead, dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        err = _lib().step_scores_root(
            *(t.data_ptr() for t in ins), part.data_ptr(), k_list.data_ptr(),
            root.data_ptr(), w, b, *_entropy_constants(),
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"step_scores_root: CUDA error {err}")
    scores_launches += 1
    return root, k_list
