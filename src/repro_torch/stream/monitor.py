"""Graph-health monitoring: streaming drift detection on served graphs.

A rolling refit silently overwrites the served graph; what makes
streaming causal discovery valuable is *detecting when the causal
mechanism itself changes*. This module watches that signal: the
structural noise of the currently served graph,

    ``e = (I - B0) r``,  ``r = y - c - A z``

with ``[y, z]`` a chunk's lag-augmented rows and ``(B0, A, c,
resid_var)`` the served VarLiNGAM estimate. Under the served model the
per-variable noises are zero-mean, of variance ``resid_var``, and
mutually independent: three testable invariants, each broken by a
different kind of structural change:

  * **mean shift** of ``e_j`` (CUSUM on the standardized chunk mean;
    alert kind ``"weight-shift"``);
  * **variance shift** of ``e_j`` (CUSUM on the standardized variance
    statistic; alert kind ``"noise-scale"``);
  * **cross-dependence** between ``e_j`` and the other noises (CUSUM on
    an LM-type score from the chunk's residual correlations; alert kind
    ``"edge-flip"``).

Everything is computed from the chunk's
:class:`~repro_torch.stream.stats.MomentState`, the (count, mean,
centered M2) summary the rolling window already produces per slide, on
the window's device: monitoring never re-reads rows. Each scored chunk
costs one small transform and one copy of its (3, d) statistics (and
the chunk's count, in the same copy) to the host, where the CUSUM banks
live. :func:`score_chunks_many` scores one chunk for each of many
sessions as one batched transform and one copy; unlike the reference,
which pads that batch to a power of two to bound its compiles, the port
batches the real sessions only.

Alerts are :class:`DriftAlert` objects carrying the implicated variable,
the firing statistic, a kind label, and candidate root variables ranked
by :func:`repro_torch.infer.rca.drift_root_candidates`.
:class:`repro_torch.stream.session.StreamSession` consumes them for its
adaptive refit cadence and
:class:`repro_torch.serve.engine.CausalDiscoveryEngine` surfaces them
through ``poll_alerts`` and flush deltas.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace

from . import stats as stats_lib
from . import window as window_lib

_EPS = 1e-12

# Statistic index -> the structural-change kind it evidences.
STAT_KINDS = ("weight-shift", "noise-scale", "edge-flip")


@dataclasses.dataclass(frozen=True)
class MonitorConfig:
    """Sequential-test knobs of one graph-health monitor.

    The per-chunk statistics are standardized to ~unit scale under the
    served model, then accumulated in per-variable CUSUMs:
    ``S <- max(0, S + z - slack)``, alerting when ``S > threshold``.
    ``slack`` absorbs steady model error (the served graph is itself an
    estimate); ``threshold`` sets the false-alarm / detection-delay
    trade-off (~``threshold / (|z| - slack)`` chunks to detect a shift
    of size ``z``). ``var_slack`` adds slack to the variance statistic,
    whose null spread is widest under heavy-tailed (LiNGAM) noise.
    """

    slack: float = 1.0
    threshold: float = 14.0
    var_slack: float = 1.0      # extra slack for the variance statistic
    dep_slack: float = 0.5      # extra slack for the dependence statistic
    min_count: int = 8          # skip chunks with fewer effective rows
    max_pending: int = 64       # bounded per-session pending-alert ring
    history: int = 256          # bounded per-session alert history ring
    rca_top_k: int = 3          # candidate roots attached per alert
    cooldown: int = 2           # chunks between repeat alerts of one
    #                             (variable, kind) while the same drift
    #                             episode keeps accumulating


@dataclasses.dataclass
class DriftAlert:
    """One sequential test crossing its alarm level."""

    sid: str                 # owning stream session ("" for library use)
    variable: int            # variable whose invariant broke
    kind: str                # "weight-shift" | "noise-scale" | "edge-flip"
    score: float             # CUSUM level / threshold (>= 1.0 at fire)
    stat: float              # the chunk statistic that tipped it
    chunk_index: int         # session chunk count when it fired
    refit_index: int         # refits completed when it fired
    candidate_roots: List[Tuple[int, float]]  # [(variable, drift score)]

    def summary(self) -> str:
        roots = ", ".join(f"x{v}:{s:.1f}" for v, s in self.candidate_roots)
        return (
            f"drift[{self.kind}] x{self.variable} score={self.score:.2f} "
            f"stat={self.stat:+.2f} chunk={self.chunk_index} "
            f"roots=[{roots}]"
        )


def chunk_drift_stats(count, mean, m2, a, intercept, b0, resid_var):
    """Per-variable standardized drift statistics of one chunk, from its
    augmented :class:`MomentState` fields alone; every argument may carry
    a leading batch axis (one chunk and one served graph per element).

    Args:
      count/mean/m2: the chunk's augmented moment summary: mean is
        ``((k+1)d,)``, m2 the centered ``((k+1)d, (k+1)d)`` sums.
      a:         (d, k d) served VAR coefficients.
      intercept: (d,) served VAR intercept.
      b0:        (d, d) served instantaneous adjacency.
      resid_var: (d,) served structural-noise variances.

    Returns ``(z_mean, z_var, z_dep)``, each ``(d,)``:
      * ``z_mean`` -- chunk mean of ``e_j`` over its served standard
        error ``sqrt(resid_var_j / n)`` (~N(0,1) under the model);
      * ``z_var``  -- ``(vhat_j / resid_var_j - 1) * sqrt(n / 2)``, with
        ``vhat`` the chunk's second moment of ``e_j`` about the model's
        zero mean;
      * ``z_dep``  -- mean over partners of ``n * corr(e_j, e_i)^2``
        (each ~chi^2(1) under independence), centered and scaled to ~unit
        variance.

    The noise moments come from the linear maps ``r = y - c - A z``,
    ``e = (I - B0) r`` applied to the chunk's mean and covariance: exact,
    no row access.
    """
    d = b0.shape[-1]
    n = torch.clamp(count.float(), min=1.0)[..., None]  # (..., 1)
    cov_u = m2 / n[..., None]
    mean_r = (mean[..., :d] - (a @ mean[..., d:, None])[..., 0]
              - intercept)
    czy = cov_u[..., d:, :d]
    cov_r = (cov_u[..., :d, :d] - a @ czy - czy.mT @ a.mT
             + a @ cov_u[..., d:, d:] @ a.mT)
    r0 = torch.eye(d, dtype=b0.dtype, device=b0.device) - b0
    mean_e = (r0 @ mean_r[..., None])[..., 0]
    cov_e = r0 @ cov_r @ r0.mT
    v0 = torch.clamp(resid_var, min=_EPS)
    var_e = torch.diagonal(cov_e, dim1=-2, dim2=-1)

    z_mean = mean_e * torch.sqrt(n / v0)
    vhat = torch.clamp(var_e, min=0.0) + mean_e ** 2
    z_var = (vhat / v0 - 1.0) * torch.sqrt(n / 2.0)

    sd = torch.sqrt(torch.clamp(var_e, min=_EPS))
    corr = cov_e / (sd[..., :, None] * sd[..., None, :])
    corr = corr - torch.diag_embed(torch.diagonal(corr, dim1=-2, dim2=-1))
    n_partners = max(d - 1, 1)
    dep = n * (corr ** 2).sum(dim=-1) / n_partners
    z_dep = (dep - 1.0) * float(np.sqrt(n_partners / 2.0))
    return z_mean, z_var, z_dep


@dataclasses.dataclass
class ServedGraph:
    """The monitor's frozen view of the estimate it scores against, as
    tensors on the fit's device."""

    a: torch.Tensor          # (d, k d) VAR coefficients
    intercept: torch.Tensor  # (d,)
    b0: torch.Tensor         # (d, d) instantaneous adjacency
    order: torch.Tensor      # (d,) causal order (for RCA ranking)
    resid_var: torch.Tensor  # (d,)

    @classmethod
    def from_fit(cls, fit: window_lib.RollingFit) -> "ServedGraph":
        if fit.intercept is None:
            raise ValueError(
                "RollingFit.intercept missing: refit through finish_refit "
                "to monitor this graph"
            )
        result = fit.result
        device = result.adjacency.device
        mats = np.asarray(fit.var_coefs)
        a = np.concatenate(list(mats), axis=1)  # [k, d, d] -> (d, k d)
        return cls(
            a=torch.as_tensor(a, dtype=torch.float32, device=device),
            intercept=torch.as_tensor(fit.intercept, dtype=torch.float32,
                                      device=device),
            b0=result.adjacency.float(),
            order=result.order,
            resid_var=result.resid_var.float(),
        )


class GraphHealthMonitor:
    """Per-session sequential tests on a served graph's noise residuals.

    Lifecycle: :meth:`arm` freezes the served estimate and zeroes the
    CUSUM banks; :meth:`update` scores one chunk's
    :class:`MomentState` and returns any :class:`DriftAlert`\\ s that
    fired. ``max_score`` summarizes the current drift level (max CUSUM
    over variables and statistics, over the threshold: 1.0 means "at the
    alarm level").
    """

    def __init__(self, config: MonitorConfig, d: int, lags: int,
                 sid: str = ""):
        self.config = config
        self.d = d
        self.lags = lags
        self.sid = sid
        self.graph: Optional[ServedGraph] = None
        self.n_scored = 0
        # CUSUM banks, (3, d): mean/var two-sided kept as (pos, neg).
        self._pos = np.zeros((3, d), np.float32)
        self._neg = np.zeros((3, d), np.float32)
        self._last_alert: Dict[Tuple[int, str], int] = {}

    @property
    def armed(self) -> bool:
        return self.graph is not None

    def arm(self, fit: window_lib.RollingFit) -> None:
        """Adopt a freshly served estimate; restart the tests."""
        self.graph = ServedGraph.from_fit(fit)
        self._pos[:] = 0.0
        self._neg[:] = 0.0
        self._last_alert.clear()

    def max_score(self) -> float:
        """Current drift level: max CUSUM / threshold (1.0 = alarm)."""
        if self.graph is None:
            return 0.0
        peak = max(float(self._pos.max()), float(self._neg.max()))
        return peak / self.config.threshold

    def variable_scores(self) -> np.ndarray:
        """(d,) per-variable drift level (max over statistics and sides,
        over the threshold): the structural-noise-frame score vector RCA
        ranks root candidates from."""
        return (
            np.maximum(self._pos, self._neg).max(axis=0)
            / self.config.threshold
        )

    def _slacks(self) -> np.ndarray:
        c = self.config
        return np.array(
            [c.slack, c.slack + c.var_slack, c.slack + c.dep_slack],
            np.float32,
        )

    def _stats(self, chunk_state: stats_lib.MomentState):
        g = self.graph
        return chunk_drift_stats(chunk_state.count, chunk_state.mean,
                                 chunk_state.m2, g.a, g.intercept, g.b0,
                                 g.resid_var)

    def update(
        self,
        chunk_state: stats_lib.MomentState,
        *,
        chunk_index: int = 0,
        refit_index: int = 0,
    ) -> List[DriftAlert]:
        """Score one chunk's moment summary; returns fired alerts. The
        chunk's statistics and count reach the host in one copy
        (:func:`score_chunks_many` scores many monitors' chunks at once)."""
        if self.graph is None:
            raise RuntimeError("monitor not armed: no served graph yet")
        host = torch.cat([chunk_state.count.reshape(1).float(),
                          torch.stack(self._stats(chunk_state)).reshape(-1)]
                         ).cpu().numpy()
        return self._absorb(float(host[0]), host[1:].reshape(3, self.d),
                            chunk_index, refit_index)

    def _absorb(self, count: float, z: np.ndarray, chunk_index: int,
                refit_index: int) -> List[DriftAlert]:
        """Advance the CUSUM banks by one chunk's (3, d) statistics."""
        if count < self.config.min_count:
            return []
        slack = self._slacks()[:, None]
        self._pos = np.maximum(0.0, self._pos + z - slack)
        # Negative side only where a drop is meaningful: means can shift
        # down, variances can collapse; the dependence score is one-sided.
        self._neg[:2] = np.maximum(0.0, self._neg[:2] - z[:2] - slack[:2])
        self.n_scored += 1

        alerts: List[DriftAlert] = []
        level = np.maximum(self._pos, self._neg)
        h = self.config.threshold
        cands = None
        for s_idx, kind in enumerate(STAT_KINDS):
            for j in np.nonzero(level[s_idx] > h)[0]:
                key = (int(j), kind)
                last = self._last_alert.get(key)
                if last is not None and (
                    chunk_index - last
                ) <= self.config.cooldown:
                    continue
                self._last_alert[key] = chunk_index
                if cands is None:
                    # The candidates depend on the graph and the banks
                    # alone: one ranking serves every alert of a chunk.
                    cands = self._root_candidates()
                alerts.append(DriftAlert(
                    sid=self.sid, variable=int(j), kind=kind,
                    score=float(level[s_idx, j] / h),
                    stat=float(z[s_idx, j]), chunk_index=chunk_index,
                    refit_index=refit_index, candidate_roots=list(cands),
                ))
        if obs_trace.enabled():
            sid = self.sid or "-"
            if alerts:
                obs_metrics.inc("monitor.alerts", len(alerts), sid=sid)
            for a in alerts:
                obs_metrics.inc("monitor.alerts_by_kind", kind=a.kind,
                                sid=sid)
            obs_metrics.gauge("monitor.drift_score", self.max_score(),
                              sid=sid)
        return alerts

    def _root_candidates(self) -> List[Tuple[int, float]]:
        from repro_torch.infer import rca

        return rca.drift_root_candidates(
            self.graph.b0, self.graph.order, self.variable_scores(),
            top_k=self.config.rca_top_k,
        )


def score_chunks_many(
    monitors: Sequence[GraphHealthMonitor],
    chunk_states: Sequence[stats_lib.MomentState],
    *,
    chunk_indices: Optional[Sequence[int]] = None,
) -> List[List[DriftAlert]]:
    """Score one chunk per monitor as one batched transform.

    All monitors must share ``(d, lags)`` and a device. The statistics
    and counts of the whole batch reach the host in one copy; then each
    monitor advances exactly as its own :meth:`GraphHealthMonitor.update`
    would.
    """
    if not monitors:
        return []
    graphs = [m.graph for m in monitors]
    if any(g is None for g in graphs):
        raise RuntimeError("every monitor must be armed before batching")

    def stack(xs):
        return torch.stack(list(xs))

    zs = chunk_drift_stats(
        stack(s.count for s in chunk_states),
        stack(s.mean for s in chunk_states),
        stack(s.m2 for s in chunk_states),
        stack(g.a for g in graphs),
        stack(g.intercept for g in graphs),
        stack(g.b0 for g in graphs),
        stack(g.resid_var for g in graphs),
    )
    counts = stack(s.count.float() for s in chunk_states)
    host = torch.cat([counts[:, None], torch.stack(zs, dim=1).flatten(1)],
                     dim=1).cpu().numpy()
    out: List[List[DriftAlert]] = []
    for i, mon in enumerate(monitors):
        idx = chunk_indices[i] if chunk_indices is not None else 0
        out.append(mon._absorb(float(host[i, 0]),
                               host[i, 1:].reshape(3, mon.d), idx, 0))
    return out


__all__ = [
    "DriftAlert",
    "GraphHealthMonitor",
    "MonitorConfig",
    "ServedGraph",
    "STAT_KINDS",
    "chunk_drift_stats",
    "score_chunks_many",
]
