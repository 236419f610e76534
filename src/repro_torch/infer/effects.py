"""Total causal effects from fitted graphs: triangular solves, no inverses.

For a LiNGAM SEM ``x = B x + e`` the total-effect matrix is
``T = (I - B)^{-1}``: ``T[i, j]`` is the change in ``x_i`` per unit
exogenous shift of ``x_j``, summed over every directed path. The fit
guarantees ``B`` is strictly lower triangular *in causal order*, so the
inverse is never formed densely: :func:`total_effects_impl` permutes
``B`` into causal order, runs one unit-lower-triangular solve against
``I`` and permutes back: O(d^3/3) operations, no pivoting. The graph
queries (:func:`total_effects_impl`, :func:`total_effects`,
:func:`target_effects_row`, :func:`effects_avoiding`,
:func:`effects_through`) also take a leading batch axis (orders (b, d),
adjacency (b, d, d)), the reference's ``vmap`` written out; they run on
the device of the tensors they are given. :func:`var_irf` takes one fit.

Also here:

  * :func:`effects_avoiding` / :func:`effects_through` -- path-specific
    effects by graph surgery: severing the *outgoing* edges of a node
    set blocks exactly the paths through it, so
    ``through = total - avoiding``.
  * :func:`var_irf` -- lag-propagated effects of a VarLiNGAM fit: the
    structural impulse responses ``Psi_h = Phi_h (I - B0)^{-1}`` of the
    VAR recursion ``Phi_h = sum_tau M_tau Phi_{h-tau}``.
  * :func:`bootstrap_effects` -- effect confidence intervals: the
    batched engine refits every resample and takes its total-effect
    matrix on the device
    (:func:`repro_torch.core.batched.bootstrap_fits_with`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core import api, batched


def _positions(order):
    """pos[..., v] = position of variable v in the causal order."""
    ranks = torch.arange(order.shape[-1], device=order.device)
    return torch.empty_like(order).scatter_(-1, order,
                                            ranks.expand_as(order))


def _permute(a, order):
    """``a[order][:, order]`` over the last two axes, per batch element."""
    d = order.shape[-1]
    rows = torch.gather(a, -2, order[..., :, None].expand(*order.shape, d))
    return torch.gather(rows, -1, order[..., None, :].expand_as(rows))


def _eye_like(b):
    return torch.eye(b.shape[-1], dtype=b.dtype, device=b.device)


def total_effects_impl(adjacency, order):
    """(d, d) total effects ``(I - B)^{-1}`` via triangular solve.

    ``adjacency`` is the fit's ``B`` (``B[i, j]`` = direct effect of
    ``x_j`` on ``x_i``), ``order`` its causal order (position p holds
    the variable index). The diagonal is 1 (every variable moves
    one-for-one with its own noise term).
    """
    b = adjacency.float()
    order = order.long()
    bo = _permute(b, order)  # strictly lower triangular by construction
    eye = _eye_like(b)
    t_ord = torch.linalg.solve_triangular(
        eye - bo, eye.expand_as(bo), upper=False, unitriangular=True)
    return _permute(t_ord, _positions(order))


def total_effects(result: api.FitResult):
    """Total-effect matrix of one fit (or of a batch of fits):
    ``T[i, j]`` = total effect of ``x_j`` on ``x_i`` (1 on the
    diagonal)."""
    return total_effects_impl(result.adjacency, result.order)


def target_effects_row(adjacency, order, target):
    """One row of the total-effect matrix: ``T[target, :]``.

    A single transposed unit-triangular solve, O(d^2) rather than the
    full O(d^3) matrix solve. ``target`` is an int or a 0-d tensor; over
    a batch of fits the rows come out (b, d), one target for all.
    """
    b = adjacency.float()
    order = order.long()
    d = b.shape[-1]
    bo = _permute(b, order)
    pos = _positions(order)
    rhs = torch.nn.functional.one_hot(pos[..., target], d).to(b.dtype)
    z = torch.linalg.solve_triangular(
        (_eye_like(b) - bo).mT, rhs[..., None], upper=True,
        unitriangular=True,
    )[..., 0]  # z[q] = T_ord[pos[target], q]
    return torch.gather(z, -1, pos)


def effects_avoiding(adjacency, order, blocked):
    """Total effects along paths avoiding the ``blocked`` node set.

    ``blocked`` is a (d,) bool mask. Severing a node's *outgoing* edges
    (its column of ``B``) removes exactly the paths that pass through
    it while leaving paths that merely end there; the mutilated graph
    keeps the same causal order, so the triangular solve applies
    unchanged.
    """
    b = torch.where(blocked[..., None, :], 0.0, adjacency.float())
    return total_effects_impl(b, order)


def effects_through(adjacency, order, nodes):
    """Total effects along paths passing through the ``nodes`` set
    (complement of :func:`effects_avoiding`; zero diagonal)."""
    return total_effects_impl(adjacency, order) - effects_avoiding(
        adjacency, order, nodes
    )


def var_irf(b0, order, var_coefs, horizon: int, device="cuda"):
    """Structural impulse responses of a VarLiNGAM fit, computed on
    ``device`` (the card unless the caller asks for ``"cpu"``; raises
    without a card).

    Args:
      b0:        (d, d) instantaneous adjacency (``theta_0``).
      order:     (d,) its causal order.
      var_coefs: (k, d, d) reduced-form VAR coefficient matrices
                 ``M_tau`` (``VarLiNGAM.var_coefs_``).
      horizon:   number of lag steps to propagate.
      device:    where the solve and the recursion run; numpy inputs
                 (the facade's ``adjacency_matrices_[0]``,
                 ``causal_order_``, ``var_coefs_``) are moved there.

    Returns:
      (horizon + 1, d, d) responses: ``irf[h, i, j]`` is the change in
      ``x_{t+h, i}`` per unit shock to the structural noise ``e_{t, j}``:
      ``irf[0] = (I - B0)^{-1}`` (instantaneous total effects), later
      steps propagate through ``Phi_h = sum_tau M_tau Phi_{h-tau}``.
    """
    device = api.resolve_device(device)
    b0 = torch.as_tensor(b0, dtype=torch.float32, device=device)
    var_coefs = torch.as_tensor(var_coefs, dtype=torch.float32,
                                device=device)
    order = torch.as_tensor(order, device=device)
    a0 = total_effects_impl(b0, order)
    eye = _eye_like(b0)
    # phis[h] = Phi_h, with Phi_h = 0 for h < 0.
    phis = [eye]
    for h in range(1, horizon + 1):
        phi = torch.zeros_like(eye)
        for tau in range(min(h, var_coefs.shape[0])):
            phi = phi + var_coefs[tau] @ phis[h - 1 - tau]
        phis.append(phi)
    return torch.stack(phis) @ a0


def _effects_post(result: api.FitResult):
    """Per-resample hook for ``batched.bootstrap_fits_with``."""
    return total_effects_impl(result.adjacency, result.order)


@dataclasses.dataclass
class EffectCI:
    """Bootstrap confidence intervals over the total-effect matrix."""

    mean: np.ndarray    # (d, d) resample mean of T
    std: np.ndarray     # (d, d)
    lo: np.ndarray      # (d, d) lower percentile bound
    hi: np.ndarray      # (d, d) upper percentile bound
    level: float        # two-sided coverage level of [lo, hi]
    n_sampling: int

    def covers(self, true_effects) -> np.ndarray:
        """(d, d) bool: does [lo, hi] contain each true effect?"""
        t = np.asarray(true_effects)
        return (self.lo <= t) & (t <= self.hi)

    def significant_effects(self, min_abs: float = 0.0):
        """[(i, j, mean, lo, hi)] for off-diagonal effects whose CI
        excludes zero (and |mean| >= min_abs), sorted by |mean|."""
        d = self.mean.shape[0]
        sig = ((self.lo > 0) | (self.hi < 0)) & ~np.eye(d, dtype=bool)
        sig &= np.abs(self.mean) >= min_abs
        out = [
            (int(i), int(j), float(self.mean[i, j]),
             float(self.lo[i, j]), float(self.hi[i, j]))
            for i, j in np.argwhere(sig)
        ]
        return sorted(out, key=lambda t: -abs(t[2]))


def effect_ci(effs: np.ndarray, level: float) -> EffectCI:
    """Percentile intervals over stacked (n_sampling, d, d) effects."""
    alpha = 0.5 * (1.0 - level)
    return EffectCI(
        mean=effs.mean(axis=0),
        std=effs.std(axis=0),
        lo=np.quantile(effs, alpha, axis=0),
        hi=np.quantile(effs, 1.0 - alpha, axis=0),
        level=level,
        n_sampling=effs.shape[0],
    )


def bootstrap_effects(
    x,
    n_sampling: int = 20,
    level: float = 0.9,
    seed: int = 0,
    config: Optional[api.FitConfig] = None,
    device="cuda",
) -> EffectCI:
    """Effect confidence intervals from one batched bootstrap.

    Every resample's refit and its total-effect triangular solve run on
    ``device`` (the card unless the caller asks for ``"cpu"``), on the
    same index matrix as ``bootstrap_lingam`` with the same seed, so the
    resamples match; only the percentile reduction runs on the host.
    """
    x = np.ascontiguousarray(x, dtype=np.float32)
    cfg = config or api.FitConfig(compaction="staged")
    xt = torch.as_tensor(x, device=api.resolve_device(device))
    indices = batched.resample_indices(seed, n_sampling, x.shape[0],
                                       device=xt.device)
    _, effs = batched.bootstrap_fits_with(xt, indices, cfg, _effects_post)
    return effect_ci(effs.cpu().numpy(), level)
