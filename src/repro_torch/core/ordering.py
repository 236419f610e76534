"""Causal ordering (Algorithm 1 of the paper).

Each ordering step, over (m, w) working data or a batch of them,
(b, m, w):

  step(X, active):
    1. standardize active columns (ddof=0)
    2. C = X_std^T X_std / m                        (one matmul)
    3. (M1, M2) = pairwise residual moments         (CUDA kernel / torch)
    4. entropies + MI differences -> k_list scores  (O(d^2) postprocess)
    5. root = argmax_{active} k_list                (ties -> lowest index)
    6. residualize: x_j <- x_j - (cov(x_j, x_root)/var(x_root)) x_root

A reducer carries out the step's sample and pair reductions: the
:class:`LocalReducer` on one device, the mesh plan's ``MeshReducer``
(:mod:`repro_torch.core.sharded`) over a ``torch.distributed`` device
mesh. The root stays a device tensor throughout: no step reads a value
back to the host, and the order is copied off the device once, at the
end, by the caller.

The local plan, on every device, runs one loop, :func:`masked_order_impl`
(the reference's name for its local ordering): step k at width w = d - k,
every column of the buffer active, w (w - 1) pairs in the moment kernel,
and the residual update writes the w - 1 surviving columns (no step at
w = 1). On a CUDA tensor the step's column passes are the hand-written
kernels of :mod:`repro_torch.kernels.step_passes` (six launches a step:
the column statistics, the standardization with the column moments and
the correlation, the residual update), and its scores and root one
``scores_root`` call (one or two launches); on a CPU tensor their plain
versions, :func:`step_standardize` (through the reducer's
``mean_over_samples`` and ``gram_mean``),
:func:`repro_torch.core.measures.nonlinear_moments`, :func:`step_scores`
with ``torch.argmax``, and :func:`compact_residualize`.

The mesh plan's reductions cross the shards between the passes, so it
runs the composed passes over a buffer whose width stays a multiple of
the pair-axis size, with one of two schedules (``FitConfig.compaction``):
:func:`full_width_order_impl`, d steps at width d with the masked
:func:`residualize`, or :func:`compact_order_impl`, which gathers the
surviving columns after each stage of :func:`_stage_schedule`. On the CPU
these two are also the composed references the tests hold the local
loop to. :func:`order_schedule` gives the widths each plan's moment
calls run at.

With telemetry on, each step's phases are spans (``order.standardize``,
with ``path="kernel"`` or ``path="composed"``, the kernels' column moments
and correlation inside it; ``order.scores``, with ``path`` likewise;
``order.residualize``; the moment call between them is
``kernels.dispatch`` and ``kernels.moments``), each stage's gather in the
staged schedule is ``order.compact``, the counter ``order.pair_terms``
adds up the w (w - 1) pairs of each moment call over the batch, and
``order.scores_kernel`` the batch's elements of each step scored by the
kernel.

Every function here takes an optional leading batch axis: data (b, m, w),
mask (b, w), roots (b,); without it, (m, w), (w,) and a 0-d root. The
batch is the reference's ``vmap`` over fits written out (the bootstrap
and many-dataset engine, :mod:`repro_torch.core.batched`): every
reduction runs over the sample or pair axis of each element, each
element picks its own root and keeps its own surviving columns, and the
moment kernel runs once per step over the whole batch. So element k
takes the same steps as a fit of x[k] alone, with the same moments (the
kernel's sums are bit for bit those of a launch on x[k]) and the same
float64 reductions rounded to float32.

The compacting loops return the same order as
:func:`full_width_order_impl`.
That needs every per-column quantity to come out the same at every
buffer width. Scores of equally valid roots (independent exogenous
variables) differ only at the level of fp32 rounding, so a reduction
whose order depends on the width (torch's column sums, cuBLAS's product)
would break ties differently in the two layouts. The reducer therefore
sums over samples and pairs in float64 and rounds the result to float32,
and the moment kernel's sums do not depend on the width; the step-pass
kernels sum in an order fixed by the sample count alone, so their
statistics, moments and correlations are the same bits at every width and
batch too.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import ops, step_passes
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace

from . import measures

_NEG_INF = -1e30
EPS = 1e-12


class StepStats(NamedTuple):
    """A step's standardization: ``x_std``, the float32 correlation ``c``,
    the float32 column means ``mu`` and variances ``var``; from the
    step-pass kernels also the column moments ``col_moments`` (cm1, cm2)
    and the float64 ``gram`` E[x_std_i x_std_j] that ``c`` rounds, which
    the kernels' residual update reads (None on the composed path)."""

    x_std: torch.Tensor
    c: torch.Tensor
    mu: torch.Tensor
    var: torch.Tensor
    col_moments: Optional[tuple] = None
    gram: Optional[torch.Tensor] = None


class LocalReducer:
    """Single-device reduction plan, over the sample axis (the second to
    last) of each batch element:

      * ``mean_over_samples(v) -> v.mean(-2)``, accumulated in float64
      * ``gram_mean(v) -> v^T v / m``, a float64 product rounded to float32
        (never TF32)
      * ``moment_rows(x_std, c) -> (M1, M2)`` pairwise residual moment
        means for all (i, j); with ``moment_chunk`` set, accumulated over
        (moment_chunk, d) sample slabs (``ops.pairwise_moments_chunked``);
        the kernel's launch plan comes from the dispatcher in mode
        ``tune``
      * ``col_moments(x_std) -> (cm1, cm2)`` per-column nonlinear moments
        for the H(x_i) entropies, composed (the step takes them from
        ``standardize`` where the kernels computed them)
      * ``standardize(x) -> StepStats``: on a CUDA tensor the step-pass
        kernels (:func:`repro_torch.kernels.step_passes.standardize`, which
        bring the column moments and the float64 Gram means along, and
        whose ``gram`` routes the step's residual update to
        :func:`repro_torch.kernels.step_passes.residualize`); on a CPU
        tensor their plain version, :func:`step_standardize` over the two
        methods above
      * ``mask_rows(v)`` -- zero the rows that are sample padding
        (identity here; a mesh shard carries a zero-padded tail)
      * ``gather_rows(rows)`` -- the full moment matrices from the plan's
        row tiles (identity here; all_gather over the pair axis on a mesh)
      * ``col_multiple`` -- buffer widths must be multiples of this (1
        here; the pair-axis size on a mesh), kept by the staged ordering
    """

    col_multiple = 1

    def __init__(self, backend: str = None, moment_chunk: int = None,
                 tune: str = "cache"):
        ops.check_backend(backend)
        self.backend = backend
        self.moment_chunk = moment_chunk
        self.tune = tune

    def mean_over_samples(self, v):
        return (v.sum(dim=-2, dtype=torch.float64) / v.shape[-2]).float()

    def gram_mean(self, v):
        v = v.double()
        return ((v.mT @ v) / v.shape[-2]).float()

    def standardize(self, x):
        if x.is_cuda:
            return StepStats(*step_passes.standardize(x))
        if x.device.type != "cpu":
            raise ValueError(f"no step-pass kernels for {x.device}")
        return StepStats(*step_standardize(x, self))

    def mask_rows(self, v):
        return v

    def gather_rows(self, rows):
        return rows

    def moment_rows(self, x_std, c):
        if self.moment_chunk:
            return ops.pairwise_moments_chunked(
                x_std, c, chunk=self.moment_chunk, backend=self.backend,
                tune=self.tune)
        return ops.pairwise_moments(x_std, c, backend=self.backend,
                                    tune=self.tune)

    def col_moments(self, x_std):
        return measures.nonlinear_moments(x_std, axis=-2)


def step_standardize(x, reducer):
    """ddof=0 standardization + correlation of the working data.

    Two-pass variance (E[(x - mu)^2]): the one-pass E[x^2] - mu^2 form
    cancels catastrophically in fp32 when column means dwarf the stds.
    Padded sample rows (mesh) are zeroed again after centering. Returns
    (x_std, c, mu, var); the residual update reuses mu and var.
    """
    mu = reducer.mean_over_samples(x)
    xc = reducer.mask_rows(x - mu[..., None, :])
    var = torch.clamp(reducer.mean_over_samples(xc * xc), min=EPS)
    x_std = xc * torch.rsqrt(var)[..., None, :]
    c = reducer.gram_mean(x_std)
    return x_std, c, mu, var


def step_scores(cm1, cm2, m1, m2, active):
    """k_list scores (float64) from the column / pairwise nonlinear
    moments, with -1e30 at inactive entries."""
    h_col = measures.entropy_from_moments(cm1, cm2)  # (..., d)
    h_res = measures.entropy_from_moments(m1, m2)  # (..., d, d), [i, j]

    # diff_mi[i, j] = (H(x_j) + H(r_i<-j)) - (H(x_i) + H(r_j<-i))
    diff = (h_col[..., None, :] + h_res) - (h_col[..., :, None] + h_res.mT)

    eye = torch.eye(active.shape[-1], dtype=torch.bool, device=active.device)
    pair_ok = active[..., :, None] & active[..., None, :] & ~eye
    contrib = torch.where(pair_ok, torch.clamp(diff, max=0.0) ** 2, 0.0)
    k_list = -contrib.sum(dim=-1, dtype=torch.float64)
    return torch.where(active, k_list, _NEG_INF)


def ordering_scores(x, active, *, backend=None):
    """k_list scores for one ordering step (local plan), on ``x.device``.

    Args:
      x:      (m, d) current (partially residualized) data.
      active: (d,) bool mask of variables still to be ordered.
    Returns:
      (k_list, x_std, c): scores with -1e30 at inactive entries; the
      standardized data and correlation (reused by the residual update).
    """
    reducer = LocalReducer(backend=backend)
    st = reducer.standardize(x)
    m1, m2 = reducer.moment_rows(st.x_std, st.c)
    cm1, cm2 = st.col_moments or reducer.col_moments(st.x_std)
    return step_scores(cm1, cm2, m1, m2, active), st.x_std, st.c


def _step_root(x, active, reducer):
    """A step's standardization and root: the :class:`StepStats` of ``x``
    and the argmax of the scores over ``active``. ``active`` None means
    every column of the buffer (the compacting loop): on the card's local
    plan the scores and the root are then one
    :func:`repro_torch.kernels.step_passes.scores_root` call (span
    ``order.scores`` with ``path="kernel"``, counter
    ``order.scores_kernel`` the batch's elements); otherwise the composed
    :func:`step_scores` and ``torch.argmax`` (``path="composed"``)."""
    with obs_trace.span("order.standardize") as sp:
        st = reducer.standardize(x)
        sp.set(path="composed" if st.gram is None else "kernel")
    w = x.shape[-1]
    b = x.shape[0] if x.dim() == 3 else 1
    obs_metrics.inc("order.pair_terms", w * (w - 1) * b)
    rows1, rows2 = reducer.moment_rows(st.x_std, st.c)
    m1, m2 = reducer.gather_rows(rows1), reducer.gather_rows(rows2)
    with obs_trace.span("order.scores") as sp:
        if active is None and st.gram is not None:
            sp.set(path="kernel")
            obs_metrics.inc("order.scores_kernel", b)
            root, _ = step_passes.scores_root(*st.col_moments, m1, m2)
            return st, root
        sp.set(path="composed")
        if active is None:
            active = torch.ones(w, dtype=torch.bool,
                                device=x.device).expand(*x.shape[:-2], w)
        cm1, cm2 = st.col_moments or reducer.col_moments(st.x_std)
        k_list = step_scores(cm1, cm2, m1, m2, active)
        root = torch.argmax(k_list, dim=-1)  # first maximum, as jnp.argmax
    return st, root


def ordering_step(x, active, reducer):
    """One masked ordering step, on the composed passes.

    Args:
      x:       (m, width) working data, or a batch (b, m, width).
      active:  (width,) or (b, width) bool mask of variables still to be
               ordered.
      reducer: the plan's reducer (:class:`LocalReducer`, or the mesh
               plan's ``MeshReducer``).
    Returns:
      (x_new, active_new, root): residualized data, updated mask, and
      the column chosen this step as a 0-d device tensor, or (b,).
    """
    st, root = _step_root(x, active, reducer)
    with obs_trace.span("order.residualize"):
        x_new, active_new = residualize(x, active, root, st.mu, st.var,
                                        reducer)
    return x_new, active_new, root


def residualize(x, active, root, mu, var, reducer):
    """Regress every other active column on ``root``'s column of the
    unstandardized working data (two-pass covariance, with the step's
    column means ``mu`` and variances ``var``). Returns the new data and
    the mask without ``root``. Padded sample rows (mesh) are masked out
    of the covariance after centering."""
    sel = root[..., None]  # (..., 1)
    xr = torch.gather(x, -1, sel[..., None, :].expand(*x.shape[:-1], 1))
    mu_r = torch.gather(mu, -1, sel)[..., None, :]
    cov = reducer.mean_over_samples(
        reducer.mask_rows((x - mu[..., None, :]) * (xr - mu_r)))
    coef = cov / torch.gather(var, -1, sel)
    cols = torch.arange(x.shape[-1], device=x.device)
    not_root = cols != sel
    update = torch.where(active & not_root, coef, 0.0)
    return x - xr * update[..., None, :], active & not_root


def survivors(root, w):
    """(..., w - 1) int64: the column of a w-wide buffer that column j' of
    the buffer without ``root``'s column holds, j' + (j' >= root)."""
    cols = torch.arange(w - 1, device=root.device)
    return cols + (cols >= root[..., None])


def compact_residualize(x, root, mu, var, labels, order, k, reducer):
    """Plain version of :func:`repro_torch.kernels.step_passes.residualize`:
    :func:`residualize` with every column active, then the root's column
    and label left out (:func:`survivors`); writes ``labels[root]`` at
    position ``k`` of ``order`` and, when one column survives, its label
    at ``k + 1``. Returns (x_new (..., m, w - 1), labels_new (..., w - 1))."""
    w = x.shape[-1]
    active = torch.ones(w, dtype=torch.bool, device=x.device)
    x_res, _ = residualize(x, active, root, mu, var, reducer)
    keep = survivors(root, w)
    x_new = torch.gather(x_res, -1,
                         keep[..., None, :].expand(*x.shape[:-1], w - 1))
    labels_new = torch.gather(labels, -1, keep)
    order[..., k] = torch.gather(labels, -1, root[..., None])[..., 0]
    if w == 2:
        order[..., k + 1] = labels_new[..., 0]
    return x_new, labels_new


def _active_width_step(x, labels, order, k, reducer):
    st, root = _step_root(x, None, reducer)
    with obs_trace.span("order.residualize"):
        if st.gram is None:
            return compact_residualize(x, root, st.mu, st.var, labels,
                                       order, k, reducer)
        return step_passes.residualize(x, root, st.gram, st.var, labels,
                                       order, k)


def masked_order_impl(x, reducer, *, d=None):
    """The local plan's ordering, compacted at every step: step k runs at
    width w = d - k, every column of the buffer active, and the residual
    update writes the w - 1 surviving columns, their labels and the root's
    label into the order; the last column needs no step. Returns the order
    as a (d,) int64 tensor on ``x``'s device, or (b, d) for a batch (b, m,
    d): the order of :func:`full_width_order_impl`, since every per-column
    quantity is the same at every width. ``d`` is the number of real
    variables; columns past it are left out. On the card the kernels'
    update does the bookkeeping; on the CPU :func:`compact_residualize`."""
    if d is not None:
        x = x[..., :d]
    lead, d = x.shape[:-2], x.shape[-1]
    x = x.float().contiguous()
    labels = torch.arange(d, device=x.device).expand(*lead, d).contiguous()
    if d == 1:
        return labels
    order = torch.empty_like(labels)
    for k in range(d - 1):
        x, labels = _active_width_step(x, labels, order, k, reducer)
    return order


def full_width_order_impl(x, reducer, *, d=None):
    """Full masked scan on the composed passes (the mesh plan's schedule
    ``"none"``): d identical steps at constant width. Returns the order
    as a (d,) int64 tensor on ``x``'s device, or (b, d) for a batch
    (b, m, d). ``d`` is the number of real variables; columns at index
    >= d (mesh padding) start inactive and are never selected."""
    width = x.shape[-1]
    d = width if d is None else d
    x = x.float().contiguous()  # sample-major rows, as the kernel reads them
    active = (torch.arange(width, device=x.device) < d).expand(
        *x.shape[:-2], width)
    order = []
    for _ in range(d):
        x, active, root = ordering_step(x, active, reducer)
        order.append(root)
    return torch.stack(order, dim=-1)


def causal_order(x, *, backend=None):
    """Full causal ordering of all d variables (local plan).

    Returns ``order`` (d,) -- order[p] is the variable at causal position
    p (order[0] = most exogenous) -- or (b, d) for a batch (b, m, d).
    """
    return masked_order_impl(x, LocalReducer(backend=backend))


def _stage_schedule(d: int, frac: float = 0.25, min_stage: int = 8):
    """Static compaction schedule: [(width, n_steps), ...], sum n = d.

    Each stage runs ``n_steps`` ordering steps at width ``width`` and then
    gathers the surviving columns into a ``width - n_steps`` buffer.
    Smaller ``frac`` compacts more aggressively: total pair work
    approaches the sequential algorithm's d^3/3 instead of the masked
    scan's d^3 (frac=0.25 => ~0.43 d^3).
    """
    if not 0.0 < frac <= 1.0:
        raise ValueError(f"compaction frac must be in (0, 1], got {frac}")
    if min_stage < 1:
        raise ValueError(f"min_stage must be >= 1, got {min_stage}")
    sched = []
    d_cur = d
    while d_cur > min_stage:
        n = max(1, int(round(d_cur * frac)))
        sched.append((d_cur, n))
        d_cur -= n
    if d_cur:
        sched.append((d_cur, d_cur))
    return tuple(sched)


def order_schedule(d: int, config=None):
    """((width, steps), ...): the widths a fit's moment calls run at on d
    variables, and how many steps run at each. The local plan (no
    ``config``, or one without a ``partition``) steps once at each width
    d .. 2; the mesh plan runs ``((d, d),)``, the masked scan, or, with
    ``config.compaction == "staged"``, :func:`_stage_schedule`."""
    if config is None or config.partition is None:
        return tuple((w, 1) for w in range(d, 1, -1))
    if config.compaction == "staged":
        return _stage_schedule(d, config.compaction_frac, config.min_stage)
    return ((d, d),)


def compact_order_impl(x, reducer, *, d=None, frac=0.25, min_stage=8):
    """Staged compaction on the composed passes (the mesh plan's schedule
    ``"staged"``): after each stage, gather the surviving columns
    into a narrower buffer (each batch element its own). Inactive columns
    never influence active ones, so the order equals
    :func:`full_width_order_impl` exactly. The schedule depends on d
    alone, so all elements of a batch share each width. ``d`` is the
    number of real variables (columns past it are mesh padding); buffer
    widths stay multiples of ``reducer.col_multiple``, the freed slots
    zeroed and inactive."""
    lead, width = x.shape[:-2], x.shape[-1]
    d = width if d is None else d
    schedule = _stage_schedule(d, frac, min_stage)
    col_multiple = reducer.col_multiple
    x = x.float().contiguous()
    # current column -> original, per element
    labels = torch.arange(width, device=x.device).expand(*lead, width)
    active = (torch.arange(width, device=x.device) < d).expand(*lead, width)
    parts = []
    for w_logical, n_steps in schedule:
        roots = []
        for _ in range(n_steps):
            x, active, root = ordering_step(x, active, reducer)
            roots.append(root)
        parts.append(torch.gather(labels, -1, torch.stack(roots, dim=-1)))
        keep = w_logical - n_steps
        if keep:
            keep_pad = ops._round_up(keep, col_multiple)
            with obs_trace.span("order.compact"):
                # Surviving columns in ascending order (inactive sort last).
                cols = torch.arange(width, device=x.device)
                idx = torch.argsort(torch.where(active, cols, width),
                                    dim=-1)[..., :keep_pad]
                x = torch.gather(x, -1, idx[..., None, :].expand(
                    *x.shape[:-1], keep_pad))
                labels = torch.gather(labels, -1, idx)
                active = (torch.arange(keep_pad, device=x.device) < keep
                          ).expand(*lead, keep_pad)
                if keep_pad != keep:
                    x = torch.where(active[..., None, :], x, 0.0)
            width = keep_pad
    return torch.cat(parts, dim=-1)

