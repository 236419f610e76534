"""Root-cause attribution by structural-noise decomposition.

In a LiNGAM SEM an observed sample decomposes *exactly* into its
exogenous noise terms: ``x - mu = A e~`` with ``A = (I - B)^{-1}`` and
``e~ = (I - B)(x - mu)``, one matmul per sample batch, no solve needed
for the decomposition itself. Attribution of an anomalous sample is then
linear algebra, not search:

  * **which variable's mechanism broke** -- the standardized noise
    scores ``z_j = e~_j / sqrt(Var e_j)``: under the fitted model each
    is ~unit-scale, so the variable whose *own* noise term is extreme
    is the root cause (its descendants look anomalous too, but their
    deviations are explained by propagation).
  * **who moved a given target** -- the exact additive split
    ``x_i - mu_i = sum_j A[i, j] e~_j``: the contribution of root ``j``
    to target ``i`` is ``A[i, j] e~_j``, summing to the target's
    deviation by construction.

The ``*_impl`` functions run on the device of the tensors they are
given and take a leading batch axis of graphs (adjacency (b, d, d), rows
(b, n, d), one target per graph), the reference's ``vmap`` written out.
:func:`attribute` is the host-facing entry; it slabs the sample axis by
the caller's ``chunk`` or by at most :data:`SAMPLE_SLAB` rows
(:func:`_sample_slab`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core import api
from repro_torch.core.batched import pow2_bucket

from .effects import target_effects_row, total_effects_impl

_EPS = 1e-12
#: Rows per device pass of the noise decomposition.
SAMPLE_SLAB = 512


def noise_terms_impl(adjacency, rows, mean):
    """(n, d) centered structural noise ``e~ = (I - B)(x - mu)``."""
    xc = rows.float() - mean.float()[..., None, :]
    return xc - xc @ adjacency.float().mT


def noise_scores_impl(adjacency, rows, mean, resid_var):
    """(n, d) standardized noise scores ``e~_j / sqrt(Var e_j)``."""
    e = noise_terms_impl(adjacency, rows, mean)
    return e * torch.rsqrt(torch.clamp(resid_var.float(), min=_EPS)
                           )[..., None, :]


def contributions_impl(adjacency, order, rows, mean, target):
    """(n, d) additive contributions of each root's noise term to the
    ``target`` variable's deviation: ``A[target, j] * e~_j`` (rows sum
    to ``x_target - mu_target``). Only the needed row of ``A`` is solved
    for (O(d^2)). ``target`` is an int, a 0-d tensor, or (b,) over a
    batch of graphs."""
    t_row = target_effects_row(adjacency, order, target)
    e = noise_terms_impl(adjacency, rows, mean)
    return e * t_row[..., None, :]


def _rca(adjacency, order, rows, mean, resid_var, target):
    """(scores, contributions) of one slab, the noise terms formed once."""
    e = noise_terms_impl(adjacency, rows, mean)
    scale = torch.rsqrt(torch.clamp(resid_var.float(), min=_EPS))
    t_row = target_effects_row(adjacency, order, target)
    return e * scale[..., None, :], e * t_row[..., None, :]


@dataclasses.dataclass
class RCAResult:
    """Attribution of a batch of (anomalous) samples."""

    scores: np.ndarray         # (n, d) standardized noise z-scores
    root: np.ndarray           # (n,) argmax |z|: the implicated variable
    target: Optional[int]      # attribution target (None: none requested)
    contributions: Optional[np.ndarray]  # (n, d) A[target, :] * e~, or None

    def ranking(self, row: int = 0, top_k: int = 5):
        """[(variable, z-score)] for one sample, by |z| descending."""
        z = self.scores[row]
        idx = np.argsort(-np.abs(z))[:top_k]
        return [(int(j), float(z[j])) for j in idx]


def _sample_slab(n: int) -> int:
    """Sample slab of the noise pass: at most :data:`SAMPLE_SLAB` rows per
    device pass, the reference's slab (its dispatcher's sample block for
    the chunked op), so that a pass holds a few (b, slab, d) tensors
    whatever n is (one (8, 1e6, 487) float32 tensor would be 15.6 GB)."""
    return min(n, SAMPLE_SLAB)


def _pad_rows(block: np.ndarray, slab: int, axis: int = 0) -> np.ndarray:
    """Zero-pad a slab along the sample axis to the next power of two
    capped at ``slab`` (full slabs pass through), as the reference does.
    Padding rows are all-zero and the per-row computations are
    independent, so real rows are unchanged (callers trim)."""
    k = block.shape[axis]
    target = pow2_bucket(k, slab)
    if target == k:
        return block
    pad = [(0, 0)] * block.ndim
    pad[axis] = (0, target - k)
    return np.pad(block, pad)


def attribute(
    result: api.FitResult,
    rows,
    *,
    mean=None,
    target: Optional[int] = None,
    chunk: Optional[int] = None,
) -> RCAResult:
    """Root-cause attribution of ``rows`` under a fitted graph, on the
    fit's device.

    Args:
      result: the fitted graph (adjacency + order + resid_var).
      rows:   (n, d) samples to attribute (or (d,) for one).
      mean:   (d,) observational mean of the training data (None =
              centered data).
      target: optional variable index; when given, the exact additive
              contribution split toward that variable is returned too.
      chunk:  bound on the sample slab per device pass; None takes
              :func:`_sample_slab`.
    """
    device = result.adjacency.device
    rows = np.asarray(rows, np.float32)
    if rows.ndim == 1:
        rows = rows[None, :]
    n, d = rows.shape
    mu = (torch.zeros((d,), device=device) if mean is None
          else torch.as_tensor(mean, dtype=torch.float32, device=device))
    slab = chunk or _sample_slab(n)
    tgt = 0 if target is None else int(target)
    scores_parts, contrib_parts = [], []
    for start in range(0, n, slab):
        block = rows[start:start + slab]
        k = block.shape[0]
        s, c = _rca(result.adjacency, result.order,
                    torch.as_tensor(_pad_rows(block, slab), device=device),
                    mu, result.resid_var, tgt)
        scores_parts.append(s[:k].cpu().numpy())
        contrib_parts.append(c[:k].cpu().numpy())
    scores = np.concatenate(scores_parts, axis=0)
    contributions = (
        np.concatenate(contrib_parts, axis=0) if target is not None else None
    )
    return RCAResult(
        scores=scores,
        root=np.argmax(np.abs(scores), axis=1),
        target=target,
        contributions=contributions,
    )


def drift_root_candidates(
    adjacency,
    order,
    drift_scores,
    *,
    top_k: int = 3,
):
    """Rank candidate root variables behind a drift episode.

    ``drift_scores`` are the graph-health monitor's per-variable
    sequential-test levels (:meth:`GraphHealthMonitor.variable_scores`),
    already in the structural-noise frame. A broken *upstream* mechanism
    still leaks into descendants' residuals, so ties are broken causally:
    each variable's own score is discounted by the strongest ancestral
    score, ancestors judged by the fitted total-effect matrix
    ``A = (I - B)^{-1}``. A variable drifting alone keeps its full score;
    one whose drifting ancestor explains it ranks below that ancestor.
    ``adjacency`` and ``order`` are tensors (on any device) or arrays.

    Returns ``[(variable, drift score)]``, strongest candidate first:
    the same shape as :meth:`RCAResult.ranking`.
    """
    z = np.abs(np.asarray(drift_scores, np.float32))
    d = z.shape[0]
    a = total_effects_impl(torch.as_tensor(adjacency),
                           torch.as_tensor(order)).cpu().numpy()
    reach = (np.abs(a) > _EPS) & ~np.eye(d, dtype=bool)  # [i, j]: j -> i
    anc_peak = np.where(reach, z[None, :], 0.0).max(axis=1)
    adjusted = z - 0.5 * np.minimum(anc_peak, z)
    idx = np.argsort(-adjusted)[:top_k]
    return [(int(j), float(z[j])) for j in idx if z[j] > 0.0]
