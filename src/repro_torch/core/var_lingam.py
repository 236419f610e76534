"""VarLiNGAM (Hyvarinen et al., 2010) -- autoregressive LiNGAM extension.

    x(t) = sum_{tau=0..k} theta_tau x(t - tau) + e(t)

Procedure (paper section 3.2):
  1. Fit a VAR(k) model by least squares -> coefficient matrices M_tau.
  2. Run DirectLiNGAM on the VAR residuals -> instantaneous matrix B0
     (where the time goes, hence the same moment kernel).
  3. Transform the lagged coefficients: theta_tau = (I - B0) @ M_tau.

    model = VarLiNGAM(lags=1).fit(X)          # on the CUDA card
    model = VarLiNGAM(device="cpu").fit(X)
    model.causal_order_          # (d,) order of the residual fit
    model.adjacency_matrices_    # [theta_0 (= B0), theta_1, ..., theta_k]

Step 2 runs :func:`repro_torch.core.api.fit_fn` on the residuals. Without
a card the default ``device="cuda"`` raises: the fit never moves to the
CPU unless asked to.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from . import api


def estimate_var(x, lags: int = 1):
    """Least-squares VAR(k) on ``x``'s device: returns (coefs [k, d, d],
    intercept [d], residuals [m - k, d]) as float32 tensors.

    The solve is ``torch.linalg.lstsq`` with the ``gels`` driver (QR),
    the only one PyTorch has on CUDA, on every device so that the CPU
    and the card run one algorithm. QR needs the lag-stacked design
    ``[1, x(t-1), ..., x(t-k)]`` to have full column rank, as it has for
    the callers' series (m - k > k d + 1 rows of a non-degenerate
    process); the reference's SVD-based ``jnp.linalg.lstsq`` would also
    return a minimum-norm answer for a rank-deficient design, which this
    port does not.
    """
    x = torch.as_tensor(x).float()
    m, d = x.shape
    y = x[lags:]  # (m - k, d)
    z = torch.cat(
        [x[lags - tau - 1:m - tau - 1] for tau in range(lags)], dim=1
    )  # (m - k, k * d), column block tau holds x(t - tau - 1)
    z1 = torch.cat([torch.ones((y.shape[0], 1), dtype=x.dtype,
                               device=x.device), z], dim=1)
    coef = torch.linalg.lstsq(z1, y, driver="gels").solution
    intercept = coef[0]
    mats = coef[1:].T.reshape(d, lags, d).permute(1, 0, 2)  # [k, d, d]
    resid = y - z1 @ coef
    return mats.contiguous(), intercept, resid


@dataclasses.dataclass
class VarLiNGAM:
    lags: int = 1
    backend: Optional[str] = None
    prune_method: str = "ols"
    prune_threshold: float = 0.0
    compaction: str = "none"
    tune: str = "cache"
    device: str = "cuda"
    partition: Optional[api.Partition] = None

    causal_order_: Optional[np.ndarray] = None
    adjacency_matrices_: Optional[List[np.ndarray]] = None  # [theta_0..k]
    var_coefs_: Optional[np.ndarray] = None
    residuals_: Optional[np.ndarray] = None
    result_: Optional[api.FitResult] = None

    def to_config(self) -> api.FitConfig:
        return api.FitConfig(
            backend=self.backend,
            prune_method=self.prune_method,
            prune_threshold=self.prune_threshold,
            compaction=self.compaction,
            tune=self.tune,
            partition=self.partition,
        )

    def fit(self, x) -> "VarLiNGAM":
        device = api.resolve_device(self.device)
        x = torch.as_tensor(np.ascontiguousarray(x, dtype=np.float32),
                            device=device)
        mats, _, resid = estimate_var(x, self.lags)
        result = api.fit_fn(resid, self.to_config())
        b0 = result.adjacency
        eye = torch.eye(b0.shape[0], dtype=b0.dtype, device=b0.device)
        thetas = [b0] + [(eye - b0) @ mats[tau] for tau in range(self.lags)]
        self.result_ = result
        self.causal_order_ = result.order.cpu().numpy()
        self.adjacency_matrices_ = [t.cpu().numpy() for t in thetas]
        self.var_coefs_ = mats.cpu().numpy()
        self.residuals_ = resid.cpu().numpy()
        return self


def fit_var_lingam(x, **kw) -> VarLiNGAM:
    return VarLiNGAM(**kw).fit(x)
