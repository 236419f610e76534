"""Batched execution engine: many DirectLiNGAM fits as one program.

The paper's accelerated ordering makes a *single* fit fast; its
applications (gene networks, stock graphs) need *many* fits: bootstrap
resamples, ensembles over datasets, scenario sweeps. This module runs
them together on the card, the reference's ``vmap`` over
``api.fit_impl`` written out as a leading batch axis:

  * :func:`fit_many` -- (b, m, d) -> batched :class:`~.api.FitResult`.
    Every ordering step is one step over the whole batch: one launch of
    the moment kernel over its batch grid axis, batched float64
    reductions, each element picking its own root (and, with
    ``compaction="staged"``, gathering its own surviving columns). The
    pruning then runs per element, so it needs one fit's memory.
  * :func:`resample_indices` -- the bootstrap index matrix, drawn on the
    device from a ``torch.Generator`` seeded with ``seed``; shared by the
    batched engine and the host loop, so both fit identical resamples.
    Its streams are not ``jax.random``'s, and a CPU and a CUDA generator
    give different indices for one seed: a parity test hands the
    reference's index matrix to both sides.
  * :func:`bootstrap_fits` / :func:`bootstrap_fits_with` -- gather and
    refit all resamples as one batch (the latter also maps ``post`` over
    the resamples' fits and stacks the tensors it returns).

This is the local plan's batch. The mesh plan (a ``partition`` in the
reference's ``FitConfig``) is the orthogonal scale-out direction and
cannot be nested inside the batch; the port's config has no partition
yet (ROADMAP item 12), and :func:`_require_local_plan` keeps the check
for when it has one.
"""

from __future__ import annotations

import torch

from .api import (FitConfig, FitResult, _check_device, fit_impl,
                  fit_impl_from_stats, resolve_device)


def pow2_bucket(n: int, cap: int) -> int:
    """Next power of two >= n, capped at ``cap``: the shared micro-batch
    padding policy, which rounds partial batches up to a bounded set of
    shapes (log2(cap) + 1 of them)."""
    b = 1
    while b < n:
        b *= 2
    return min(b, cap)


def _require_local_plan(config: FitConfig, engine: str) -> None:
    if getattr(config, "partition", None) is not None:
        raise ValueError(
            f"{engine} batches the local execution plan and cannot nest a "
            "mesh partition; drop config.partition, or fit each dataset "
            "through api.fit_fn (the mesh plan)."
        )


def _check_batch(xs) -> None:
    if xs.dim() != 3:
        raise ValueError(f"xs must be (b, m, d), got {tuple(xs.shape)}")


def fit_many(xs, config: FitConfig = FitConfig()) -> FitResult:
    """Fit every dataset in ``xs`` (b, m, d), on ``xs.device``; returns a
    batched FitResult (order: (b, d), adjacency: (b, d, d), resid_var:
    (b, d))."""
    _require_local_plan(config, "fit_many")
    _check_batch(xs)
    _check_device(xs)
    return fit_impl(xs, config)


def fit_many_from_stats(
    xs, means, covs, config: FitConfig = FitConfig()
) -> FitResult:
    """Batched :func:`~.api.fit_from_stats`: datasets (b, m, d) with
    their precomputed moments, means (b, d) and ddof=0 covariances
    (b, d, d). The ordering of all b runs as one batch; with
    ``config.moment_chunk`` each step is one slab-structured launch over
    every element's slabs."""
    _require_local_plan(config, "fit_many_from_stats")
    _check_batch(xs)
    _check_device(xs)
    return fit_impl_from_stats(xs, means, covs, config)


def warmup_fit_many(shape, config: FitConfig = FitConfig(), *,
                    batch: int = 1, device="cuda"):
    """Prime the engine for datasets of ``shape`` (m, d) before traffic
    arrives: one zeros fit of ``batch`` datasets on ``device``, which
    builds the kernel library (nvcc at first use) and loads it. Raises
    without a card unless ``device="cpu"``."""
    m, d = shape
    xs = torch.zeros((batch, m, d), dtype=torch.float32,
                     device=resolve_device(device))
    fit_many(xs, config).order.cpu()


def resample_indices(seed: int, n_sampling: int, m: int, *, device="cuda"):
    """(n_sampling, m) int64 bootstrap row indices, drawn on ``device``
    (the card unless the caller asks for ``"cpu"``) from a generator
    seeded with ``seed``: deterministic on one device type, but not
    jax.random's stream, and not the same on the CPU as on the card."""
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return torch.randint(0, m, (n_sampling, m), generator=gen, device=device)


def _resamples(x, indices):
    return x.float()[indices]  # (n_sampling, m, d), contiguous


def bootstrap_fits(x, indices, config: FitConfig = FitConfig()) -> FitResult:
    """All bootstrap refits as one batch.

    Args:
      x:       (m, d) data tensor.
      indices: (n_sampling, m) resample rows on ``x``'s device (see
               :func:`resample_indices`).
    Returns:
      The batched FitResult over resamples (adjacency: (n_sampling, d,
      d)). Edge statistics are a cheap host-side reduction over it
      (``bootstrap._summarize``).
    """
    _require_local_plan(config, "bootstrap_fits")
    _check_device(x)
    return fit_impl(_resamples(x, indices), config)


def bootstrap_fits_with(
    x, indices, config: FitConfig, post
) -> "tuple[FitResult, torch.Tensor]":
    """:func:`bootstrap_fits` plus a per-resample reduction.

    ``post`` maps each resample's :class:`FitResult` to a tensor, on the
    device, right after the batch's fits: the query subsystem's
    total-effect matrices, for one
    (:func:`repro_torch.infer.effects.bootstrap_effects`). Returns
    ``(batched FitResult, post's tensors stacked over resamples)``.
    """
    _require_local_plan(config, "bootstrap_fits_with")
    _check_device(x)
    fits = fit_impl(_resamples(x, indices), config)
    return fits, torch.stack([post(r) for r in fits.unbind()])
