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
    them. Without an explicit config or model it orders with staged
    compaction (same order as the masked scan, about half the pair work).
  * ``strategy="loop"`` -- one ``fit_fn`` call per resample, in O(m * d)
    memory: the fallback for shapes whose resample stack is too large,
    and the equivalence oracle of the engine's tests.
  * ``strategy="auto"`` (default) -- vmap when ~4x the resample stack
    fits ``max_vmap_bytes`` (default 1 GiB), loop otherwise.

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

from . import api, batched
from .api import FitConfig


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
    the ordering schedule: the batched engine defaults to staged
    compaction; the loop keeps the full scan.
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


def bootstrap_lingam(
    x,
    n_sampling: int = 20,
    threshold: float = 0.05,
    seed: int = 0,
    backend: Optional[str] = None,
    model=None,
    strategy: str = "auto",
    config: Optional[FitConfig] = None,
    max_vmap_bytes: int = 1 << 30,
    device="cuda",
) -> BootstrapResult:
    """Edge probabilities and coefficient statistics over ``n_sampling``
    resamples of the rows of ``x`` (m, d), fitted on ``device`` (raises
    without a card unless ``device="cpu"``)."""
    x = np.ascontiguousarray(x, dtype=np.float32)
    m, d = x.shape
    if strategy == "auto":
        # The batch holds several live (n_sampling, m, d) fp32 buffers at
        # once (resample stack, working data, standardized view), so
        # budget ~4x the raw stack.
        est_bytes = 4 * (4 * n_sampling * m * d)
        strategy = "vmap" if est_bytes <= max_vmap_bytes else "loop"
    if strategy not in ("vmap", "loop"):
        raise ValueError(f"unknown strategy: {strategy}")
    cfg = _resolve_config(backend, model, config, strategy)
    xt = torch.as_tensor(x, device=api.resolve_device(device))
    indices = batched.resample_indices(seed, n_sampling, m, device=xt.device)

    if strategy == "vmap":
        coefs = batched.bootstrap_fits(xt, indices, config=cfg).adjacency
    else:
        coefs = torch.stack([api.fit_fn(xt[idx], cfg).adjacency
                             for idx in indices])
    return _summarize(coefs.cpu().numpy(), threshold)
