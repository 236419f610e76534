"""Functional estimator core: DirectLiNGAM fits as plain functions.

The stateful ``DirectLiNGAM`` facade sits over the types here:

  * :class:`FitConfig` -- frozen estimator settings.
  * :class:`Partition` -- an optional mesh-partition spec inside the
    config: mesh axes and sizes, which axes shard the samples, which axis
    tiles the (i, j) pair rows, the sample padding granularity.
  * :class:`FitResult` -- one fit, or a batch of fits: order, adjacency,
    residual variances, as tensors on the fit's device.

``fit_fn(x, config)`` is the whole fit (ordering, adjacency,
diagnostics) on ``x.device``: the CUDA kernel carries the pairwise
moments on a card, the kernel's plain version on the CPU. The order is
copied to the host once, by the caller that reads it. The config picks
the execution plan, all three scoring a step the same way
(:mod:`repro_torch.core.ordering`):

  * **local** (``partition=None``) -- one device, the ordering compacted
    at every step;
  * **batched** -- :mod:`repro_torch.core.batched` runs the local plan
    over a leading axis of datasets;
  * **mesh** (``partition=Partition(...)``) -- :mod:`repro_torch.core.
    sharded` over a ``torch.distributed`` device mesh: samples sharded
    over the sample axes (all_reduce), pair rows tiled over the pair
    axis (all_gather), then the pruning with its row solves tiled.

    from repro_torch.core import api
    res = api.fit_fn(x, api.FitConfig())
    res.order       # (d,) int64 causal order
    res.adjacency   # (d, d) f32 connection strengths
    res.resid_var   # (d,) f32 residual noise variances
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.kernels import ops
from repro_torch.obs import profile as obs_profile

from . import ordering, pruning


@dataclasses.dataclass(frozen=True)
class Partition:
    """Mesh-partition spec for the mesh execution plan.

    ``mesh`` is a tuple of (axis_name, size) pairs, e.g.
    ``(("data", 2), ("model", 2))``: the product is the world size of the
    ``torch.distributed`` process group the fit runs in (a 1 x 1 mesh
    runs in one process without one; ``launch.mesh.mesh_scope``).
    ``sample_axes`` shard the sample dimension (all_reduce);
    ``pair_axis`` tiles the (i, j) pair rows (all_gather). Samples are
    padded to a multiple of ``n_sample_shards * chunk`` and variables to
    a multiple of the pair axis size (padded columns enter inactive and
    are never selected). The moment kernel needs no sample chunking, so
    ``chunk`` only sets that padding: with shards a multiple of the
    kernel's 128-sample sub-sums, the moments are bit for bit the local
    plan's. ``fused_standardize`` folds the standardization into the
    raw-X Gram product (one standardized-slab product saved a step).

    ``gather_finish`` picks the adjacency/diagnostics tail:
      * ``True`` (default) -- reassemble the data on every rank and
        reduce the covariance there: the local plan's arithmetic, with
        the OLS row solves tiled over the pair axis;
      * ``False`` -- the fully sharded finish: covariance all_reduced
        over the sample shards, diagnostics on local rows. Per-rank
        memory stays O(m_local * d + d^2), at fp32 reduction-order
        agreement instead of bit-equality.
    """

    mesh: Tuple[Tuple[str, int], ...] = (("data", 1), ("model", 1))
    sample_axes: Tuple[str, ...] = ("data",)
    pair_axis: str = "model"
    chunk: int = 512
    fused_standardize: bool = False
    gather_finish: bool = True

    def __post_init__(self):
        if isinstance(self.mesh, dict):
            object.__setattr__(self, "mesh", tuple(self.mesh.items()))
        else:
            object.__setattr__(
                self, "mesh", tuple((str(a), int(s)) for a, s in self.mesh)
            )
        if isinstance(self.sample_axes, str):
            object.__setattr__(self, "sample_axes", (self.sample_axes,))
        else:
            object.__setattr__(self, "sample_axes", tuple(self.sample_axes))
        names = [a for a, _ in self.mesh]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate axis names in mesh {self.mesh}")
        for ax in (*self.sample_axes, self.pair_axis):
            if ax not in names:
                raise ValueError(f"axis {ax!r} not in mesh {self.mesh}")
        if self.pair_axis in self.sample_axes:
            # An overlapping spec would sum different pair-row tiles
            # together (wrong moments), never just run slower.
            raise ValueError(
                f"pair_axis {self.pair_axis!r} must be disjoint from "
                f"sample_axes {self.sample_axes}"
            )
        if any(s < 1 for _, s in self.mesh) or self.chunk < 1:
            raise ValueError(
                f"mesh sizes and chunk must be >= 1: {self.mesh}, "
                f"chunk={self.chunk}")


@dataclasses.dataclass(frozen=True)
class FitConfig:
    """Configuration of one DirectLiNGAM fit.

    ``backend``: ``None`` (the CUDA kernel on a card, its plain version on
    the CPU), ``"cuda"``, ``"blocked"`` or ``"ref"``.

    ``compaction``, ``compaction_frac`` and ``min_stage`` select the mesh
    plan's ordering schedule; only the mesh plan reads them:
      * ``"none"``   -- the full masked scan (d identical steps,
                        ``ordering.full_width_order_impl``).
      * ``"staged"`` -- active-set compaction every stage
                        (``ordering.compact_order_impl``): same order,
                        about half the pair work.
    The local plan compacts its buffer at every step
    (``ordering.masked_order_impl``): the same order again, with the
    pair work the ordering needs, d^3 / 3.

    ``moment_chunk``: when set, the ordering's pairwise moments
    accumulate over (moment_chunk, d) sample slabs
    (``ops.pairwise_moments_chunked``: on the card one row-tile kernel
    launch over all the slabs), so the plain versions' residual
    intermediate is O(chunk * d^2) whatever m is. Valid with backend
    ``None``, ``"cuda"`` or ``"blocked"``.

    ``tune`` selects how the kernels' launch plans are decided
    (:mod:`repro_torch.kernels.tune`): ``"off"`` -- the deterministic
    heuristic, no table reads; ``"cache"`` (default) -- tuned plans from
    the persistent table, heuristic fallback, never measures; ``"auto"``
    -- a timed search on a table miss, persisted to the local overlay.
    Tuned and heuristic plans give bit-identical moments, so ``tune``
    never changes results, only speed.

    ``partition`` selects the execution plan: ``None`` for the local
    (single-device / batched) plan, a :class:`Partition` for the mesh
    plan. The mesh plan pads its sample shards through
    ``Partition.chunk`` and ignores ``moment_chunk``.

    ``prune_kwargs`` is stored as a sorted tuple of (key, value) pairs so
    the config stays hashable; a dict is normalized on construction.
    """

    backend: Optional[str] = None
    prune_method: str = "ols"
    prune_threshold: float = 0.0
    prune_kwargs: Tuple[Tuple[str, Any], ...] = ()
    compaction: str = "none"
    compaction_frac: float = 0.25
    min_stage: int = 8
    moment_chunk: Optional[int] = None
    tune: str = "cache"
    partition: Optional[Partition] = None

    def __post_init__(self):
        if isinstance(self.prune_kwargs, dict):
            object.__setattr__(
                self, "prune_kwargs", tuple(sorted(self.prune_kwargs.items()))
            )
        ops.check_backend(self.backend)
        if self.tune not in ("off", "cache", "auto"):
            raise ValueError(
                f"tune must be 'off', 'cache', or 'auto', got {self.tune!r}"
            )
        if self.compaction not in ("none", "staged"):
            raise ValueError(f"unknown compaction: {self.compaction}")
        if self.moment_chunk is not None:
            if self.backend not in (None, "cuda", "blocked"):
                raise ValueError(
                    "moment_chunk requires backend None, 'cuda' or 'blocked' "
                    f"(chunk accumulation has no {self.backend!r} variant)"
                )
            if self.moment_chunk < 1:
                raise ValueError(
                    f"moment_chunk must be >= 1, got {self.moment_chunk}"
                )

    @property
    def prune_kwargs_dict(self) -> Dict[str, Any]:
        return dict(self.prune_kwargs)


@dataclasses.dataclass
class FitResult:
    """One fit, as tensors on the fit's device; a batch of fits (from
    :func:`fit_impl` over (b, m, d), ``batched.fit_many``) carries a
    leading batch axis on every field."""

    order: torch.Tensor      # (d,) int64 -- position p holds the variable
    adjacency: torch.Tensor  # (d, d) f32 -- B[i, j] = effect of x_j on x_i
    resid_var: torch.Tensor  # (d,) f32 -- Var(x_i - B_i x) diagnostic

    @classmethod
    def stack(cls, results) -> "FitResult":
        """The batch of the given fits, in order."""
        return cls(*(torch.stack(parts) for parts in zip(
            *((r.order, r.adjacency, r.resid_var) for r in results))))

    def unbind(self):
        """The fits of a batch, in order (views of its tensors)."""
        return [FitResult(*parts) for parts in zip(
            self.order, self.adjacency, self.resid_var)]

    @classmethod
    def from_numpy(cls, order, adjacency, resid_var, device="cuda"):
        """A result from numpy arrays (e.g. another implementation's fit),
        on ``device``: the card unless the caller asks for ``"cpu"``
        (raises without a card)."""
        device = resolve_device(device)
        return cls(
            order=torch.tensor(np.asarray(order), dtype=torch.long,
                               device=device),
            adjacency=torch.tensor(np.asarray(adjacency),
                                   dtype=torch.float32, device=device),
            resid_var=torch.tensor(np.asarray(resid_var),
                                   dtype=torch.float32, device=device),
        )

    def to_numpy(self):
        """(order, adjacency, resid_var) as numpy arrays on the host."""
        return (
            self.order.cpu().numpy(),
            self.adjacency.cpu().numpy(),
            self.resid_var.cpu().numpy(),
        )


def tf32_enabled() -> bool:
    """Whether float32 matmuls on the card may run in TF32."""
    matmul = torch.backends.cuda.matmul
    precision = getattr(matmul, "fp32_precision", None)
    if precision is not None:
        return precision == "tf32"
    return bool(matmul.allow_tf32)


def resolve_device(device) -> torch.device:
    """``torch.device(device)``; raises for a CUDA device when there is no
    card, so that an entry point never moves to the CPU unless asked."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU"
        )
    return device


def _check_device(x):
    if x.is_cuda and tf32_enabled():
        # C = X^T X / m must be the exact ddof=0 correlation for the
        # identity std(r_ij) = sqrt(1 - C_ij^2); TF32 keeps ~3 digits and
        # can flip orders. PyTorch's default is full fp32.
        raise RuntimeError(
            "TF32 matmuls are enabled (torch.backends.cuda.matmul); the "
            "fit needs full-fp32 correlations: turn TF32 off"
        )


def _order_for_config(x, config: FitConfig):
    return ordering.masked_order_impl(x, ordering.LocalReducer(
        backend=config.backend, moment_chunk=config.moment_chunk,
        tune=config.tune))


def finish_fit(x, order, config: FitConfig) -> FitResult:
    """Adjacency + residual diagnostics given the causal order."""
    b = pruning.estimate_adjacency(
        x,
        order,
        method=config.prune_method,
        threshold=config.prune_threshold,
        **config.prune_kwargs_dict,
    )
    xc = x - x.mean(dim=0, keepdim=True)
    resid = xc - xc @ b.T
    resid_var = (resid * resid).mean(dim=0)
    return FitResult(order=order, adjacency=b, resid_var=resid_var)


def fit_impl(x, config: FitConfig) -> FitResult:
    """Ordering then pruning, on ``x.device``.

    Over a batch ``x`` (b, m, d) the ordering runs batched (one moment
    kernel launch per step for all b) and pruning with the residual
    diagnostics runs per element: the memory of one fit's pruning, and
    each adjacency the one a fit of x[k] alone gives for the same order.
    """
    x = x.float()
    with obs.span("fit.ordering", d=x.shape[-1]):
        order = _order_for_config(x, config)
    with obs.span("fit.pruning", method=config.prune_method):
        if x.dim() == 3:
            return FitResult.stack([finish_fit(xk, ok, config)
                                    for xk, ok in zip(x, order)])
        return finish_fit(x, order, config)


def fit_fn(x, config: FitConfig = FitConfig()) -> FitResult:
    """DirectLiNGAM fit: (m, d) tensor + config -> FitResult on x.device.

    With ``config.partition`` set the fit runs the mesh plan
    (:func:`repro_torch.core.sharded.fit_sharded`) and returns the same
    :class:`FitResult`: on the CPU bit for bit the local plan's where the
    shards line up with the kernel's sub-sums, within fp32 reduction order
    elsewhere; on the card within float32 rounding of the local plan's
    (whose ordering steps run the step-pass kernels of
    :mod:`repro_torch.kernels.step_passes`, the mesh plan's the composed
    passes, which reduce across shards), so equally valid roots may be
    broken differently. TF32 is off by default in PyTorch
    (``torch.backends.cuda.matmul``); the fit raises if it has been
    turned on.
    """
    _check_device(x)
    if config.partition is not None:
        from . import sharded

        with obs.span("fit.mesh", m=x.shape[0], d=x.shape[1]):
            return sharded.fit_sharded(x, config)
    with obs.span("fit.local", m=x.shape[0], d=x.shape[1]):
        return obs_profile.call(fit_impl, x, config, op="core.fit",
                                shape=x.shape, config=config)


_STATS_EPS = 1e-12


def standardize_from_stats(x, mean, cov):
    """(x - mean) / sqrt(diag(cov)) in float32: the data the ordering of
    :func:`fit_from_stats` starts from (over a leading batch axis too)."""
    var = torch.clamp(torch.diagonal(cov.float(), dim1=-2, dim2=-1),
                      min=_STATS_EPS)
    return ((x.float() - mean.float()[..., None, :])
            * torch.rsqrt(var)[..., None, :])


def _finish_from_cov(cov, order, config: FitConfig) -> FitResult:
    b = pruning.estimate_adjacency_from_cov(
        cov,
        order,
        method=config.prune_method,
        threshold=config.prune_threshold,
        **config.prune_kwargs_dict,
    )
    r = torch.eye(b.shape[0], dtype=b.dtype, device=b.device) - b
    resid_var = torch.clamp(torch.einsum("ij,jk,ik->i", r, cov, r), min=0.0)
    return FitResult(order=order, adjacency=b, resid_var=resid_var)


def fit_impl_from_stats(x, mean, cov, config: FitConfig) -> FitResult:
    """:func:`fit_from_stats` without the device check; over a batch
    (x (b, m, d), mean (b, d), cov (b, d, d)) the ordering runs batched
    and the pruning per element, as :func:`fit_impl`."""
    cov = cov.float()
    with obs.span("fit.ordering", d=x.shape[-1]):
        order = _order_for_config(standardize_from_stats(x, mean, cov),
                                  config)
    with obs.span("fit.pruning", method=config.prune_method):
        if x.dim() == 3:
            return FitResult.stack([_finish_from_cov(ck, ok, config)
                                    for ck, ok in zip(cov, order)])
        return _finish_from_cov(cov, order, config)


def fit_from_stats(
    x, mean, cov, config: FitConfig = FitConfig()
) -> FitResult:
    """DirectLiNGAM fit that reuses precomputed sufficient statistics.

    ``mean``/``cov`` are the (d,) mean and (d, d) ddof=0 covariance of
    ``x`` (e.g. from a rolling moment store). They replace every data
    pass the fit can avoid: the initial standardization, the pruning
    solves (from ``cov``), and the residual diagnostics
    ``diag((I-B) cov (I-B)^T)``. Only the nonlinear ordering moments
    still read the rows (chunk-bounded with ``config.moment_chunk``).
    The mesh plan has no from-stats variant: a partitioned config
    raises.
    """
    if config.partition is not None:
        raise ValueError(
            "fit_from_stats runs the local/batched plans only; the mesh "
            "plan recomputes statistics shard-locally: drop "
            "config.partition or use fit_fn."
        )
    _check_device(x)
    return fit_impl_from_stats(x, mean, cov, config)
