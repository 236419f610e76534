"""Bootstrap confidence for discovered edges (the paper's applications
report gene networks and stock graphs with edge stability, not single
point estimates).

Resamples rows with replacement, refits DirectLiNGAM per resample, and
returns edge-presence probabilities plus coefficient means/stds.
Deterministic under a seed on one device type.

Two execution strategies share one index matrix drawn on the device
(:func:`repro_torch.core.batched.resample_indices`), so they fit
*identical* resamples and their summaries agree:

  * ``strategy="vmap"`` -- the batched engine
    (:func:`~repro_torch.core.batched.bootstrap_fits`): all resamples as
    one batch, one moment kernel launch per ordering step for all of
    them. Without an explicit config or model it takes the reference's
    ``compaction="staged"`` (read by the mesh plan only).
  * ``strategy="loop"`` -- one ``fit_fn`` call per resample, in O(m * d)
    memory: the fallback for shapes whose resample stack is too large,
    and the equivalence oracle of the engine's tests.
  * ``strategy="auto"`` (default) -- vmap when its memory fits, loop
    otherwise. On the card the need is :func:`vmap_peak_bytes`, a model
    of the batched fit's own buffers, and the budget the device's free
    memory (or ``max_vmap_bytes`` when given). On the CPU it is the
    reference's rule: ~4x the resample stack against ``max_vmap_bytes``
    (default 1 GiB).

Pass ``config=FitConfig(...)`` to pin every estimator setting (both
strategies honor it verbatim); ``model=DirectLiNGAM(...)`` adopts all of
the model's settings.

Unlike the reference, the default ``backend`` is ``None`` (the CUDA
kernel on the card, its plain version on the CPU), and the fits run on
``device``: the card unless the caller asks for ``"cpu"``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import pairwise_stats

from . import api, batched
from .api import FitConfig

_CPU_VMAP_BYTES = 1 << 30  # the reference's budget


@dataclasses.dataclass
class BootstrapResult:
    edge_prob: np.ndarray    # (d, d) P(|B_ij| > threshold)
    coef_mean: np.ndarray    # (d, d) mean coefficient over resamples
    coef_std: np.ndarray     # (d, d)
    n_sampling: int

    def stable_edges(self, min_prob: float = 0.7):
        """[(i, j, prob, mean_coef)] sorted by probability."""
        idx = np.argwhere(self.edge_prob >= min_prob)
        out = [
            (int(i), int(j), float(self.edge_prob[i, j]),
             float(self.coef_mean[i, j]))
            for i, j in idx
        ]
        return sorted(out, key=lambda t: -t[2])


def _resolve_config(
    backend: Optional[str],
    model,
    config: Optional[FitConfig],
    strategy: str,
) -> FitConfig:
    """Estimator settings, in priority: explicit config > model > args.

    A passed model is adopted verbatim (including its ``compaction``).
    Only when neither config nor model is given does the strategy pick
    ``compaction``, as the reference does: "staged" for the batched
    engine, "none" for the loop.
    """
    if config is not None:
        return config
    if model is not None:
        return model.to_config()
    compaction = "staged" if strategy == "vmap" else "none"
    return FitConfig(backend=backend, compaction=compaction)


def _summarize(coefs: np.ndarray, threshold: float) -> BootstrapResult:
    """Shared (strategy-independent) reduction of stacked coefficients."""
    n_sampling = coefs.shape[0]
    present = (np.abs(coefs) > threshold).astype(float).sum(axis=0)
    return BootstrapResult(
        edge_prob=present / n_sampling,
        coef_mean=coefs.mean(axis=0),
        coef_std=coefs.std(axis=0),
        n_sampling=n_sampling,
    )


def vmap_peak_bytes(n_sampling: int, m: int, d: int) -> int:
    """Model of the vmap bootstrap's peak device memory. The ordering
    peaks in B1's launch, at full width: its two (n_sampling, n_z, d, d)
    float32 partial-sum buffers, three float32 (n_sampling, m, d) stacks
    (the resamples, the step's standardized and residualized data), and
    five float32 (n_sampling, d, d) matrices' worth (the correlation,
    B1's two sums, the float64 gram). One fit's float64 pruning (the
    pruning runs per resample) adds its resample's float64 copy and
    centered copy, and six (d, d) float64 matrices about its one factor.
    It counts these as if all were live at once, so it errs high: the
    pruning runs after the ordering."""
    n_z = pairwise_stats.slab_plan(m).n_z
    stack = 4 * n_sampling * m * d
    return (2 * 4 * n_sampling * n_z * d * d + 3 * stack
            + 5 * 4 * n_sampling * d * d + 16 * m * d + 48 * d * d)


def _auto_strategy(n_sampling, m, d, device, max_vmap_bytes) -> str:
    """The ``"auto"`` choice: vmap when its memory fits the budget."""
    if device.type == "cuda":
        need = vmap_peak_bytes(n_sampling, m, d)
        if max_vmap_bytes is None:
            free, _ = torch.cuda.mem_get_info(device)
            # Memory the caching allocator holds but does not use is free
            # to the batched fit too.
            max_vmap_bytes = free + (torch.cuda.memory_reserved(device)
                                     - torch.cuda.memory_allocated(device))
    else:
        # The batch holds several live (n_sampling, m, d) fp32 buffers at
        # once (resample stack, working data, standardized view), so
        # budget ~4x the raw stack.
        need = 4 * (4 * n_sampling * m * d)
        if max_vmap_bytes is None:
            max_vmap_bytes = _CPU_VMAP_BYTES
    return "vmap" if need <= max_vmap_bytes else "loop"


def bootstrap_lingam(
    x,
    n_sampling: int = 20,
    threshold: float = 0.05,
    seed: int = 0,
    backend: Optional[str] = None,
    model=None,
    strategy: str = "auto",
    config: Optional[FitConfig] = None,
    max_vmap_bytes: Optional[int] = None,
    device="cuda",
) -> BootstrapResult:
    """Edge probabilities and coefficient statistics over ``n_sampling``
    resamples of the rows of ``x`` (m, d), fitted on ``device`` (raises
    without a card unless ``device="cpu"``). ``max_vmap_bytes`` is the
    ``"auto"`` rule's budget (None: the card's free memory, or 1 GiB on
    the CPU)."""
    x = np.ascontiguousarray(x, dtype=np.float32)
    m, d = x.shape
    device = api.resolve_device(device)
    if strategy == "auto":
        strategy = _auto_strategy(n_sampling, m, d, device, max_vmap_bytes)
    if strategy not in ("vmap", "loop"):
        raise ValueError(f"unknown strategy: {strategy}")
    cfg = _resolve_config(backend, model, config, strategy)
    xt = torch.as_tensor(x, device=device)
    indices = batched.resample_indices(seed, n_sampling, m, device=xt.device)

    if strategy == "vmap":
        coefs = batched.bootstrap_fits(xt, indices, config=cfg).adjacency
    else:
        coefs = torch.stack([api.fit_fn(xt[idx], cfg).adjacency
                             for idx in indices])
    return _summarize(coefs.cpu().numpy(), threshold)
