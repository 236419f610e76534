"""Incremental moment store: mergeable sufficient statistics.

:class:`MomentState` holds the (count, mean, centered second moment) of a
set of sample rows as float32 tensors on one device, closed under two
operations:

  * ``merge(a, b)`` -- Chan et al.'s pairwise update: the state of the
    union of two disjoint row sets, from their states alone. The second
    moments stay *centered* end to end and the cross term enters as a
    rank-1 ``outer(delta, delta)`` correction, so it never forms the
    one-pass ``E[x^2] - mu^2``, which cancels in float32.
  * ``retract(s, b)`` -- the exact algebraic inverse of ``merge``: the
    state of ``s``'s rows minus ``b``'s. A rolling window advances by
    absorbing the new chunk and retracting the expired one, O(chunk d^2)
    per slide instead of an O(window d^2) rescan.

``update_chunk`` / ``retract_chunk`` wrap the two with a direct two-pass
summary of the raw rows (:func:`from_chunk`).

Retraction is subtraction, so float32 error accumulates with the
*stream length*, not the window length. It is safe while the window
mean drifts slowly relative to the column scales; otherwise re-anchor
by rebuilding the state from the live chunks
(``RollingVarLiNGAM(reanchor_every=...)``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import api


@dataclasses.dataclass
class MomentState:
    """Sufficient statistics of ``count`` sample rows in R^d.

    ``m2`` is the *centered* second-moment sum
    ``sum_t (x_t - mean)(x_t - mean)^T``; divide by ``count`` for the
    ddof=0 covariance. ``count`` is a 0-d float32 tensor, as in the
    reference.
    """

    count: torch.Tensor  # ()     f32 -- number of absorbed rows
    mean: torch.Tensor   # (d,)   f32
    m2: torch.Tensor     # (d, d) f32 -- centered second-moment sums

    def merge(self, other: "MomentState") -> "MomentState":
        return merge(self, other)

    def update_chunk(self, rows) -> "MomentState":
        return update_chunk(self, rows)

    def retract_chunk(self, rows) -> "MomentState":
        return retract_chunk(self, rows)

    @property
    def covariance(self):
        return covariance(self)

    @classmethod
    def from_numpy(cls, count, mean, m2, device="cuda") -> "MomentState":
        """A state from host arrays (e.g. another implementation's), on
        ``device``: the card unless the caller asks for ``"cpu"``
        (raises without a card)."""
        device = api.resolve_device(device)

        def f32(a):
            return torch.tensor(np.asarray(a, dtype=np.float32),
                                device=device)
        return cls(count=f32(count), mean=f32(mean), m2=f32(m2))

    def to_numpy(self):
        """(count, mean, m2) as float32 numpy arrays on the host."""
        return (self.count.cpu().numpy(), self.mean.cpu().numpy(),
                self.m2.cpu().numpy())


def init(d: int, device="cuda") -> MomentState:
    """Empty state over d variables (identity of ``merge``), on
    ``device``: the card unless the caller asks for ``"cpu"`` (raises
    without a card)."""
    device = api.resolve_device(device)
    return MomentState(
        count=torch.zeros((), dtype=torch.float32, device=device),
        mean=torch.zeros((d,), dtype=torch.float32, device=device),
        m2=torch.zeros((d, d), dtype=torch.float32, device=device),
    )


def from_chunk(rows) -> MomentState:
    """Direct two-pass summary of (n, d) raw rows, on their device.

    The ground truth the merge/retract algebra must round-trip to: mean
    first, then centered outer products -- never ``E[x^2] - mu^2``.
    """
    rows = torch.as_tensor(rows).float()
    n = rows.shape[0]
    mu = rows.mean(dim=0)
    xc = rows - mu[None, :]
    count = torch.full((), float(n), dtype=torch.float32, device=rows.device)
    return MomentState(count=count, mean=mu, m2=xc.T @ xc)


def merge(a: MomentState, b: MomentState) -> MomentState:
    """Chan-style pairwise merge of two disjoint row sets' states.

    Commutative and associative up to float32 rounding; ``init(d)`` is
    the identity. Safe when either side is empty.
    """
    n = a.count + b.count
    n_safe = torch.clamp(n, min=1.0)
    delta = b.mean - a.mean
    mean = a.mean + delta * (b.count / n_safe)
    m2 = a.m2 + b.m2 + torch.outer(delta, delta) * (a.count * b.count / n_safe)
    return MomentState(count=n, mean=mean, m2=m2)


def retract(s: MomentState, b: MomentState) -> MomentState:
    """Inverse merge: the state of ``s``'s rows with ``b``'s removed.

    Exact algebraic inverse of ``merge(a, b) -> s`` solved for ``a``;
    requires ``b``'s rows to be a subset of the mass in ``s``.
    Retracting everything returns a zeroed state (guarded divisions).
    """
    na = s.count - b.count
    na_safe = torch.clamp(na, min=1.0)
    mean_a = (s.count * s.mean - b.count * b.mean) / na_safe
    delta = b.mean - mean_a
    m2 = s.m2 - b.m2 - torch.outer(delta, delta) * (
        na * b.count / torch.clamp(s.count, min=1.0)
    )
    empty = na <= 0.0
    return MomentState(
        count=torch.clamp(na, min=0.0),
        mean=torch.where(empty, 0.0, mean_a),
        m2=torch.where(empty, 0.0, m2),
    )


def update_chunk(s: MomentState, rows) -> MomentState:
    """Absorb (n, d) raw rows: ``merge(s, from_chunk(rows))``."""
    return merge(s, from_chunk(torch.as_tensor(rows, device=s.mean.device)))


def retract_chunk(s: MomentState, rows) -> MomentState:
    """Remove previously absorbed (n, d) raw rows from the state."""
    return retract(s, from_chunk(torch.as_tensor(rows, device=s.mean.device)))


def covariance(s: MomentState):
    """(d, d) ddof=0 covariance of the absorbed rows."""
    return s.m2 / torch.clamp(s.count, min=1.0)


def variance(s: MomentState):
    """(d,) ddof=0 per-column variances."""
    return torch.diagonal(covariance(s))


def correlation(s: MomentState, eps: float = 1e-12):
    """(d, d) correlation derived from the covariance."""
    cov = covariance(s)
    sd = torch.clamp(torch.sqrt(torch.clamp(torch.diagonal(cov), min=0.0)),
                     min=eps)
    return cov / (sd[:, None] * sd[None, :])
