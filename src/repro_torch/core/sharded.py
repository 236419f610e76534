"""Mesh execution plan over ``torch.distributed``: the scale-out extension
(the port of the reference's ``core/sharded.py``).

The paper parallelizes Algorithm 1 within one GPU. This module is the
**mesh** plan of the shared ordering step
(:func:`repro_torch.core.ordering.ordering_step`): it holds no estimator
math of its own. Scores, entropies, moment integrands, the residual
update, the compaction schedule and the pruning all come from
:mod:`repro_torch.core.ordering`, :mod:`repro_torch.core.measures`,
:mod:`repro_torch.kernels` and :mod:`repro_torch.core.pruning`. What lives
here is the :class:`MeshReducer` (how the step's reductions run on a
``DeviceMesh``, one process a rank) and the padding and sharding around
it:

  * samples are sharded over the sample axes (``data``, and ``pod``):
    every moment is a mean over samples, so shards reduce with one
    ``all_reduce(SUM)``;
  * the (i, j) pair rows are tiled over the pair axis (``model``): each
    rank launches kernel B2 (``pairwise_moment_sums_rows``) on its i-row
    tile only, at its own ``row_start``, and the tiles are reassembled
    with ``all_gather_into_tensor``.

Collectives per ordering step:
    all_reduce(mean, var, C)   : 2 d + d^2      fp64 over the sample axes
    all_reduce(S1, S2 tiles)   : 2 d^2/|pair|   fp32 over the sample axes
    all_reduce(column moments) : 2 d            fp64 over the sample axes
    all_gather(M rows)         : 2 d^2          fp32 over the pair axis
    all_reduce(residual cov)   : d              fp64 over the sample axes

:func:`fit_sharded` runs the whole fit: the ordering (with staged
compaction when configured: buffer widths stay multiples of the pair-axis
size, every rank gathers the same surviving columns), then the adjacency
and the residual diagnostics. The finish has two modes
(``Partition.gather_finish``): the default reassembles the data on every
rank and runs the local plan's finish there (one float64 factor for
OLS); ``gather_finish=False`` keeps the finish sharded (all_reduced
covariance, the per-variable OLS solves tiled over the pair axis,
local-row diagnostics), so per-rank memory stays O(m_local * d + d^2)
for the data.

Variables are padded to a multiple of the pair-axis size and samples to
a multiple of (sample shards x ``chunk``); padded columns enter
inactive, and padded sample rows are zeroed so they drop out of every
moment sum. The moment sums are bit for bit the local plan's where each
shard is a whole number of the kernel's 128-sample sub-sums (its split
plan depends on the sample count): every 1 x 1 mesh, and the 2 x 2 cells
of the tests. Elsewhere they agree to fp32 summation order.

The reductions over samples run in float64 (then rounded to float32),
as the local reducer's, so the order and the column statistics do not
depend on how the samples are split.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.kernels.nonlinearity import nonlinear_terms
from repro_torch.launch import mesh as launch_mesh
from repro_torch.obs import compile_log
from repro_torch.obs import profile as obs_profile

from . import api, ordering, pruning
from .api import FitConfig, FitResult


def _all_reduce(t, groups):
    """Sum ``t`` in place over each process group in turn."""
    for g in groups:
        dist.all_reduce(t, group=g)
    obs_profile.note_collective("all-reduce",
                                len(groups) * t.numel() * t.element_size())
    return t


def _all_gather(t, group, n: int):
    """The tiles ``t`` of the ``n`` ranks of ``group``, stacked along
    dimension 0 in rank order."""
    t = t.contiguous()
    out = t.new_empty((n * t.shape[0], *t.shape[1:]))
    dist.all_gather_into_tensor(out, t, group=group)
    obs_profile.note_collective("all-gather", t.numel() * t.element_size())
    return out


def _axis_sizes(mesh):
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def _shard_id(mesh, sample_axes) -> int:
    """This rank's index among the sample shards (major axis first)."""
    sizes, shard = _axis_sizes(mesh), 0
    for ax in sample_axes:
        shard = shard * int(sizes[ax]) + mesh.get_local_rank(ax)
    return shard


class MeshReducer:
    """Mesh reduction plan: all_reduce over the sample shards, row tiles
    and all_gather over the pair axis. Implements the reducer interface
    documented on :class:`repro_torch.core.ordering.LocalReducer`, on
    this rank's (m_local, width) shard of the samples.
    """

    def __init__(
        self,
        mesh,
        *,
        m: int,
        m_local: int,
        sample_axes=("data",),
        pair_axis: str = "model",
        backend: str = None,
        fused_standardize: bool = False,
        tune: str = "cache",
    ):
        sizes = _axis_sizes(mesh)
        self.m = m
        self.inv_m = float(np.float32(1.0 / m))  # the local plan's f32 1/m
        self.sample_groups = [mesh.get_group(ax) for ax in sample_axes]
        self.sample_sizes = [int(sizes[ax]) for ax in sample_axes]
        self.pair_group = mesh.get_group(pair_axis)
        self.n_pair = int(sizes[pair_axis])
        self.pair_rank = mesh.get_local_rank(pair_axis)
        self.col_multiple = self.n_pair
        self.backend = backend
        self.fused_standardize = fused_standardize
        self.tune = tune
        # This rank's block of rows starts at shard_id * m_local; the
        # zero-padded tail lives on the last shard(s).
        self.shard_id = _shard_id(mesh, sample_axes)
        self.m_local = m_local
        self._valid = None

    def valid_rows(self, device):
        """(m_local, 1) bool: which local rows are real samples."""
        if self._valid is None:
            rows = self.shard_id * self.m_local + torch.arange(
                self.m_local, device=device)
            self._valid = (rows < self.m)[:, None]
        return self._valid

    def mean_over_samples(self, v):
        """Global sample mean of the local rows (padded rows are zero, so
        the local sums are sums over real rows)."""
        s = _all_reduce(v.sum(dim=-2, dtype=torch.float64),
                        self.sample_groups)
        return (s / self.m).float()

    def gram_mean(self, v):
        v = v.double()
        return (_all_reduce(v.mT @ v, self.sample_groups) / self.m).float()

    def mask_rows(self, v):
        # Padded sample rows must stay exactly zero *after* centering.
        return torch.where(self.valid_rows(v.device), v, 0.0)

    def standardize(self, x):
        if not self.fused_standardize:
            return ordering.StepStats(*ordering.step_standardize(x, self))
        # The correlation from the raw-X Gram product and an affine fold,
        # C = D (G/m - mu mu^T) D with G = X^T X, D = diag(rstd): one
        # standardized-slab product saved a step (padded rows are zero,
        # so the raw second moments are exact). The variance stays
        # two-pass, as in the shared path.
        mu = self.mean_over_samples(x)
        xc = self.mask_rows(x - mu[None, :])
        var = torch.clamp(self.mean_over_samples(xc * xc), min=ordering.EPS)
        rstd = torch.rsqrt(var)
        x_std = xc * rstd[None, :]
        g = self.gram_mean(x)
        c = (g - mu[:, None] * mu[None, :]) * (rstd[:, None] * rstd[None, :])
        return ordering.StepStats(x_std, c.contiguous(), mu, var)

    def moment_rows(self, x_std, c):
        """This rank's i-row tile of the pairwise residual moment means:
        kernel B2 at this rank's ``row_start`` over the local samples,
        the sums all_reduced over the sample shards and scaled by the
        local plan's f32 1/m."""
        tile = x_std.shape[-1] // self.n_pair
        s1, s2 = ops.pairwise_moment_sums_rows(
            x_std, c, self.pair_rank * tile, tile, backend=self.backend,
            tune=self.tune)
        s1 = _all_reduce(s1, self.sample_groups)
        s2 = _all_reduce(s2, self.sample_groups)
        return s1 * self.inv_m, s2 * self.inv_m

    def gather_rows(self, rows):
        return _all_gather(rows, self.pair_group, self.n_pair)

    def col_moments(self, x_std):
        # Padded rows are zero and both integrands vanish at 0; log cosh
        # is masked again all the same.
        logcosh, uexp = nonlinear_terms(x_std)
        logcosh = torch.where(self.valid_rows(x_std.device), logcosh, 0.0)
        return (self.mean_over_samples(logcosh),
                self.mean_over_samples(uexp))

    def gather_samples(self, x_local):
        """The full (m_pad, width) array from the sample shards (a gather
        moves bits, it does not reduce)."""
        x_full = x_local
        for g, n in reversed(list(zip(self.sample_groups,
                                      self.sample_sizes))):
            x_full = _all_gather(x_full, g, n)  # minor axis first
        return x_full


def _order_sharded(x_local, d, config: FitConfig, reducer: MeshReducer):
    """The configured ordering schedule on the mesh plan."""
    if config.compaction == "staged":
        return ordering.compact_order_impl(
            x_local, reducer, d=d, frac=config.compaction_frac,
            min_stage=config.min_stage)
    return ordering.full_width_order_impl(x_local, reducer, d=d)


def _pair_row_tiles(reducer: MeshReducer, order, d: int):
    """Row tiling over the pair axis: (mask rows, rows_of, gather).

    The row dimension is padded so every rank owns an equal tile; padded
    rows have all-False masks and solve to exactly zero before ``gather``
    slices them off.
    """
    n_pair = reducer.n_pair
    d_rows = ops._round_up(d, n_pair)
    row_tile = d_rows // n_pair
    row_start = reducer.pair_rank * row_tile

    def rows_of(full):
        padded = F.pad(full, (0, 0, 0, d_rows - d))
        return padded[row_start:row_start + row_tile]

    def gather(rows):
        return _all_gather(rows, reducer.pair_group, n_pair)[:d]

    return rows_of(pruning.pred_mask(order)), rows_of, gather


def _finish_sharded(x, order, config: FitConfig):
    """The gathered finish (``gather_finish=True``) on the reassembled
    (m, d) data: :func:`repro_torch.core.api.finish_fit` itself,
    replicated on every rank, so the adjacency is the local plan's."""
    res = api.finish_fit(x, order, config)
    return res.adjacency, res.resid_var


def _finish_sharded_scaled(x_local, order, config: FitConfig,
                           reducer: MeshReducer, d: int):
    """The sharded finish (``gather_finish=False``): the data are never
    reassembled. The covariance is all_reduced over the sample shards,
    the OLS solves run on pair-axis row tiles, the adaptive lasso (from a
    float64 covariance) runs replicated through the shared estimator, and
    the residual diagnostics stay on local rows. Coefficients agree with
    the gathered finish to the reduction order."""
    x = x_local[:, :d]
    mask_rows, rows_of, gather = _pair_row_tiles(reducer, order, d)
    mu = reducer.mean_over_samples(x)
    xc = reducer.mask_rows(x - mu[None, :])
    if config.prune_method == "ols":
        cov = reducer.gram_mean(xc)
        b = gather(pruning.ols_rows(cov, mask_rows, rows_of(cov)))
    elif config.prune_method == "adaptive_lasso":
        # The local plan's estimator, replicated on every rank, from the
        # covariance of the data centered and summed in float64.
        xd = x.double()
        groups = reducer.sample_groups
        mu64 = _all_reduce(xd.sum(dim=-2), groups) / reducer.m
        xd = reducer.mask_rows(xd - mu64[None, :])
        cov64 = _all_reduce(xd.mT @ xd, groups) / reducer.m
        b = pruning.adaptive_lasso_from_cov(
            cov64, order, **config.prune_kwargs_dict).to(x.dtype)
    else:
        raise ValueError(f"unknown method: {config.prune_method}")
    b = pruning.apply_threshold(b, config.prune_threshold)
    resid = xc - xc @ b.T  # padded rows are zero: zero residuals
    return b, reducer.mean_over_samples(resid * resid)


def _sample_shards(part) -> int:
    sizes = dict(part.mesh)
    n = 1
    for ax in part.sample_axes:
        n *= sizes[ax]
    return n


@functools.lru_cache(maxsize=None)
def _program_shape(m: int, d: int, config: FitConfig):
    """(m_pad, d_pad, m_local) of the mesh program for one (m, d, config),
    logged once per process as a ``sharded.fit`` compile event."""
    part = config.partition
    n_sample = _sample_shards(part)
    m_pad = ops._round_up(m, n_sample * part.chunk)
    d_pad = ops._round_up(d, dict(part.mesh)[part.pair_axis])
    compile_log.record("sharded.fit", shape=(m, d), config=config,
                       mesh="x".join(str(s) for _, s in part.mesh))
    return m_pad, d_pad, m_pad // n_sample


def _fit_shard(x_local, mesh, m: int, d: int, config: FitConfig):
    """The full fit on this rank's (m_local, d_pad) sample shard:
    (order, adjacency, resid_var), replicated on every rank."""
    part = config.partition
    reducer = MeshReducer(
        mesh, m=m, m_local=x_local.shape[0], sample_axes=part.sample_axes,
        pair_axis=part.pair_axis, backend=config.backend,
        fused_standardize=part.fused_standardize, tune=config.tune)
    order = _order_sharded(x_local, d, config, reducer)
    if part.gather_finish:
        x_full = reducer.gather_samples(x_local)[:m, :d].contiguous()
        b, resid_var = _finish_sharded(x_full, order, config)
    else:
        b, resid_var = _finish_sharded_scaled(x_local, order, config,
                                              reducer, d)
    return order, b, resid_var


def _shard_rows(x_pad, mesh, sample_axes, m_local: int):
    """This rank's block of sample rows of the padded global data."""
    shard = _shard_id(mesh, sample_axes)
    return x_pad[shard * m_local:(shard + 1) * m_local].contiguous()


def fit_sharded(x, config: FitConfig) -> FitResult:
    """The mesh plan of ``api.fit_fn``: pad, shard, run the full fit.

    Every rank passes the same global (m, d) data and gets the same
    :class:`FitResult`, on ``x.device``. The mesh comes from
    ``launch.mesh.mesh_scope`` over the process group (a world of one is
    set up for a 1 x 1 mesh when none exists). Bit for bit the local
    plan's at the parity cells the tests pin, within fp32 reduction order
    in general.
    """
    part = config.partition
    if part is None:
        raise ValueError("fit_sharded requires config.partition")
    x = x.float()
    m, d = x.shape
    m_pad, d_pad, m_local = _program_shape(m, d, config)
    with launch_mesh.mesh_scope(part.mesh, x.device.type) as mesh:
        x_pad = F.pad(x, (0, d_pad - d, 0, m_pad - m))
        x_local = _shard_rows(x_pad, mesh, part.sample_axes, m_local)
        # Keyed on the unpadded (m, d) + config, as the compile event.
        order, b, resid_var = obs_profile.call(
            _fit_shard, x_local, mesh, m, d, config, op="sharded.fit",
            shape=(m, d), config=config)
    return FitResult(order=order, adjacency=b, resid_var=resid_var)


def make_sharded_causal_order(
    mesh,
    m: int,
    d: int,
    *,
    sample_axes=("data",),
    pair_axis="model",
    chunk: int = 512,
    backend: str = None,
    fused_standardize: bool = False,
    tune: str = "cache",
):
    """An ordering-only mesh function for global data of shape (m, d).

    Returns (fn, m_pad, d_pad): every rank calls ``fn(x_padded)`` with the
    same (m_pad, d_pad) padded global data; it orders this rank's shard
    and returns the (d,) causal order, replicated.
    ``fused_standardize`` folds the standardization into the raw-X Gram
    product (see :meth:`MeshReducer.standardize`).
    """
    sizes = _axis_sizes(mesh)
    n_sample = 1
    for ax in sample_axes:
        n_sample *= int(sizes[ax])
    m_pad = ops._round_up(m, n_sample * chunk)
    d_pad = ops._round_up(d, int(sizes[pair_axis]))
    m_local = m_pad // n_sample

    def ordered(x_pad):
        x_local = _shard_rows(x_pad.float(), mesh, sample_axes, m_local)
        reducer = MeshReducer(
            mesh, m=m, m_local=m_local, sample_axes=sample_axes,
            pair_axis=pair_axis, backend=backend,
            fused_standardize=fused_standardize, tune=tune)
        return ordering.full_width_order_impl(x_local, reducer, d=d)

    return ordered, m_pad, d_pad


def sharded_causal_order(x, mesh, **kw):
    """Pads, shards, runs :func:`make_sharded_causal_order`'s function;
    returns the (d,) order."""
    m, d = x.shape
    fn, m_pad, d_pad = make_sharded_causal_order(mesh, m, d, **kw)
    return fn(F.pad(x.float(), (0, d_pad - d, 0, m_pad - m)))
