"""DirectLiNGAM (Shimizu et al., 2011) -- the paper's accelerated target.

Public API:

    model = DirectLiNGAM().fit(X)          # on the CUDA card
    model = DirectLiNGAM(device="cpu").fit(X)
    model.causal_order_   # (d,) -- position p holds the variable index
    model.adjacency_      # (d, d) -- B[i, j] = direct effect of x_j on x_i

A thin stateful facade over the functional core: ``fit`` moves the data
to ``device`` as float32, runs :func:`repro_torch.core.api.fit_fn` there
and keeps the result as numpy attributes. ``backend`` picks the
pairwise-moment implementation (see :mod:`repro_torch.kernels.ops`).
Without a card the default ``device="cuda"`` raises: the fit never moves
to the CPU unless asked to.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from . import api


@dataclasses.dataclass
class DirectLiNGAM:
    backend: Optional[str] = None
    prune_method: str = "ols"
    prune_threshold: float = 0.0
    prune_kwargs: dict = dataclasses.field(default_factory=dict)
    compaction: str = "none"
    tune: str = "cache"
    device: str = "cuda"
    partition: Optional[api.Partition] = None

    causal_order_: Optional[np.ndarray] = None
    adjacency_: Optional[np.ndarray] = None
    resid_var_: Optional[np.ndarray] = None
    result_: Optional[api.FitResult] = None

    def to_config(self) -> api.FitConfig:
        """The FitConfig equivalent of this facade's settings."""
        return api.FitConfig(
            backend=self.backend,
            prune_method=self.prune_method,
            prune_threshold=self.prune_threshold,
            prune_kwargs=dict(self.prune_kwargs),
            compaction=self.compaction,
            tune=self.tune,
            partition=self.partition,
        )

    def fit(self, x) -> "DirectLiNGAM":
        device = api.resolve_device(self.device)
        x = torch.as_tensor(np.ascontiguousarray(x, dtype=np.float32),
                            device=device)
        result = api.fit_fn(x, self.to_config())
        self.result_ = result
        order, adjacency, resid_var = result.to_numpy()
        self.causal_order_ = order
        self.adjacency_ = adjacency
        self.resid_var_ = resid_var
        return self


def fit_direct_lingam(x, **kw) -> DirectLiNGAM:
    return DirectLiNGAM(**kw).fit(x)
