"""Do-operator surgery: interventional moments from observational ones.

``do(x_S = v)`` on a linear SEM ``x = B x + e`` severs the *incoming*
edges of every intervened variable (its rows of ``B``) and pins its
value; the post-intervention distribution then follows from the
mutilated graph and the noise statistics alone:

    mu' solves (I - B') mu' = c,   c_i = v_i (i in S) else E[e_i]
    Sigma' = A' D' A'^T,           A' = (I - B')^{-1},
                                   D' = diag(Var e), zero on S

Both are triangular solves in the fit's causal order (mutilation only
*removes* edges, so the order still triangularizes ``B'``): no dense
inverse. Interventions are dense (d,) do-masks and values, so a batch
of queries with different target sets has one shape.

The noise statistics come from *observational* moments via
:func:`noise_stats`: ``E[e] = (I - B) mu`` and
``Var e = diag((I - B) Sigma (I - B)^T)``. A stream session's moment
store already holds ``mu``/``Sigma``
(:class:`repro_torch.stream.stats.MomentState`), so
:func:`interventional_from_state` answers interventional queries
without re-reading a row.
"""

from __future__ import annotations

from typing import Mapping, Tuple

import numpy as np
import torch

from repro_torch.core import api

from .effects import _permute, _positions, total_effects_impl

_VAR_EPS = 0.0  # noise variances may be exactly zero (pinned nodes)


def mutilate(adjacency, do_mask):
    """Graph surgery: sever the incoming edges (rows) of every
    intervened variable. ``do_mask`` is a (d,) bool mask."""
    return torch.where(do_mask[..., :, None], 0.0, adjacency)


def do_arrays(d: int,
              do: Mapping[int, float]) -> Tuple[np.ndarray, np.ndarray]:
    """Dense (mask, values) encoding of a ``{var: value}`` intervention:
    every intervention has the same (d,) shape."""
    mask = np.zeros((d,), bool)
    values = np.zeros((d,), np.float32)
    for j, v in do.items():
        mask[int(j)] = True
        values[int(j)] = float(v)
    return mask, values


def noise_stats(adjacency, mean, cov):
    """Structural-noise moments implied by observational moments.

    For ``x = B x + e``: ``E[e] = (I - B) mu`` and (with independent
    noise, as LiNGAM assumes) ``Var e_i = ((I - B) Sigma (I - B)^T)_ii``.
    Returns ``(noise_mean (d,), noise_var (d,))``.
    """
    b = adjacency.float()
    r = torch.eye(b.shape[-1], dtype=b.dtype, device=b.device) - b
    noise_mean = r @ mean.float()
    noise_var = torch.clamp(
        torch.einsum("ij,jk,ik->i", r, cov.float(), r), min=_VAR_EPS)
    return noise_mean, noise_var


def interventional_mean_impl(adjacency, order, do_mask, do_values, noise_mean):
    """(d,) post-intervention mean by triangular solve in causal order;
    over a leading batch axis of every argument, (b, d)."""
    b = mutilate(adjacency.float(), do_mask)
    order = order.long()
    c = torch.where(do_mask, do_values, noise_mean).float()
    bo = _permute(b, order)
    eye = torch.eye(b.shape[-1], dtype=b.dtype, device=b.device)
    mu_ord = torch.linalg.solve_triangular(
        eye - bo, torch.gather(c, -1, order)[..., None], upper=False,
        unitriangular=True,
    )[..., 0]
    return torch.gather(mu_ord, -1, _positions(order))


def interventional_cov_impl(adjacency, order, do_mask, noise_var):
    """(d, d) post-intervention covariance ``A' D' A'^T`` (intervened
    variables are pinned: zero variance rows/columns); over a leading
    batch axis, (b, d, d)."""
    b = mutilate(adjacency.float(), do_mask)
    a = total_effects_impl(b, order)
    var = torch.where(do_mask, 0.0, noise_var.float())
    return (a * var[..., None, :]) @ a.mT


def interventional_moments(
    result: api.FitResult,
    do: Mapping[int, float],
    *,
    mean=None,
    cov=None,
):
    """Post-intervention (mean, covariance) of a fitted graph, as numpy.

    ``mean``/``cov`` are the *observational* moments of the data the
    graph was fitted on (a sample mean/covariance, or a moment store's:
    see :func:`interventional_from_state`). With ``mean=None`` the data
    is taken as centered; with ``cov=None`` the noise variances fall
    back to the fit's ``resid_var`` diagnostics (exact for the OLS
    pruner, which makes residuals empirically uncorrelated with
    predecessors). The solves run on the fit's device.
    """
    adjacency = result.adjacency.float()
    device = adjacency.device
    d = int(result.order.shape[0])
    do_mask, do_values = (torch.as_tensor(a, device=device)
                          for a in do_arrays(d, do))
    mean = (torch.zeros(d, device=device) if mean is None
            else torch.as_tensor(mean, dtype=torch.float32, device=device))
    if cov is None:
        r = torch.eye(d, device=device) - adjacency
        noise_mean = r @ mean
        noise_var = result.resid_var.float()
    else:
        noise_mean, noise_var = noise_stats(
            adjacency, mean, torch.as_tensor(cov, device=device))
    mu = interventional_mean_impl(adjacency, result.order, do_mask,
                                  do_values, noise_mean)
    sigma = interventional_cov_impl(adjacency, result.order, do_mask,
                                    noise_var)
    return mu.cpu().numpy(), sigma.cpu().numpy()


def interventional_from_state(
    result: api.FitResult,
    state,
    do: Mapping[int, float],
):
    """Interventional moments straight from a stream's moment store.

    ``state`` is a :class:`repro_torch.stream.stats.MomentState` over the
    fitted variables, or a *lag-augmented* one (a rolling VarLiNGAM
    window's state), whose leading (d, d) block holds the instantaneous
    moments; the block is sliced out here. No rows are re-read.
    """
    d = int(result.order.shape[0])
    mean = state.mean[:d]
    cov = state.covariance[:d, :d]
    return interventional_moments(result, do, mean=mean, cov=cov)
