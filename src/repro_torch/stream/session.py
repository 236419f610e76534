"""Streaming sessions: per-client rolling state + graph deltas.

A :class:`StreamSession` wraps one :class:`~repro_torch.stream.window.
RollingVarLiNGAM`: clients post (chunk, d) row blocks, the session tracks
when a refit is *due* (window full and ``refit_every`` chunks absorbed
since the last estimate), and each completed refit is summarized as a
:class:`GraphDelta` against the session's previous adjacency.

Sessions do not execute refits themselves in serving: the engine
(:class:`repro_torch.serve.engine.CausalDiscoveryEngine`) collects due
sessions, groups their :class:`~repro_torch.stream.window.RefitPlan`\\ s
by (shape, fit-config) bucket, and runs each bucket through the batched
``fit_many_from_stats``. ``StreamSession.refit_now`` keeps a direct
single-session path.

With a :class:`~repro_torch.stream.monitor.MonitorConfig` attached, every
posted chunk's moment summary is also scored against the currently
served graph (:mod:`repro_torch.stream.monitor`: no row re-reads), and
the refit cadence becomes *adaptive*: a :class:`DriftAlert` makes the
session due immediately, while alert-free refits whose graph barely
moved let the cadence coast (doubling up to ``coast_max``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core import api
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.ring import BoundedRing

from . import monitor as monitor_lib
from . import window as window_lib


@dataclasses.dataclass(frozen=True)
class StreamConfig:
    """Static shape/cadence knobs of one streaming session.

    ``chunk`` rows arrive per post; ``window_chunks`` chunks form the
    rolling window; a refit is due every ``refit_every`` chunks once the
    window is full. ``delta_threshold`` binarizes adjacencies for the
    edge add/remove sets. ``reanchor_every`` (slides) caps moment-
    retraction drift on non-stationary streams (0 = never).

    ``monitor`` attaches a graph-health monitor to the session (None =
    no drift detection, fixed cadence). ``coast_max`` enables adaptive
    cadence: after an alert-free refit whose graph was judged stable, the
    refit interval doubles, up to ``coast_max`` chunks; any drift alert
    resets it to ``refit_every`` and makes the session due at once (0 =
    fixed cadence even when monitored). Stability is the monitor's drift
    level below 0.5 when there is a monitor, else an adjacency that moved
    by at most ``delta_threshold``.
    """

    d: int
    chunk: int
    window_chunks: int
    lags: int = 1
    refit_every: int = 1
    delta_threshold: float = 0.05
    reanchor_every: int = 0
    fit: api.FitConfig = api.FitConfig(compaction="staged")
    monitor: Optional[monitor_lib.MonitorConfig] = None
    coast_max: int = 0


@dataclasses.dataclass
class GraphDelta:
    """One refit's change against the session's previous estimate."""

    refit_index: int            # 0 for the first estimate of a session
    n_edges: int                # |{(i, j): |B0_ij| > threshold}| now
    added: np.ndarray           # (a, 2) int (i, j) edges newly above
    removed: np.ndarray         # (r, 2) int edges newly below
    max_abs_change: float       # max |B0_new - B0_prev| (0.0 on first)
    frob_change: float          # ||B0_new - B0_prev||_F (0.0 on first)
    drift_score: float = 0.0    # monitor level at refit time (1.0 = alarm)
    triggered_by: str = "cadence"   # "cadence" | "alert"
    alerts: List[monitor_lib.DriftAlert] = dataclasses.field(
        default_factory=list)    # the alerts that forced this refit

    def summary(self) -> str:
        base = (
            f"refit {self.refit_index}: edges={self.n_edges} "
            f"+{len(self.added)}/-{len(self.removed)} "
            f"max|dB|={self.max_abs_change:.4f} "
            f"frob(dB)={self.frob_change:.4f}"
        )
        if self.triggered_by == "alert" or self.drift_score > 0.0:
            kinds = ",".join(sorted({a.kind for a in self.alerts})) or "-"
            base += (
                f" drift={self.drift_score:.2f} by={self.triggered_by}"
                f"[{kinds}]"
            )
        return base


def graph_delta(
    prev: Optional[np.ndarray],
    new: np.ndarray,
    threshold: float,
    refit_index: int,
) -> GraphDelta:
    """Edge-set and magnitude delta between two adjacency estimates."""
    new = np.asarray(new)
    mask_new = np.abs(new) > threshold
    if prev is None:
        return GraphDelta(
            refit_index=refit_index,
            n_edges=int(mask_new.sum()),
            added=np.argwhere(mask_new),
            removed=np.zeros((0, 2), dtype=np.int64),
            max_abs_change=0.0,
            frob_change=0.0,
        )
    prev = np.asarray(prev)
    mask_prev = np.abs(prev) > threshold
    diff = new - prev
    return GraphDelta(
        refit_index=refit_index,
        n_edges=int(mask_new.sum()),
        added=np.argwhere(mask_new & ~mask_prev),
        removed=np.argwhere(mask_prev & ~mask_new),
        max_abs_change=float(np.abs(diff).max()),
        frob_change=float(np.linalg.norm(diff)),
    )


class StreamSession:
    """One client's rolling discovery state.

    ``device`` holds the rolling window's moment state and fits
    (default the CUDA card; raises without one unless ``"cpu"``).
    """

    def __init__(self, sid: str, config: StreamConfig, *, device="cuda"):
        self.sid = sid
        self.config = config
        self.rolling = window_lib.RollingVarLiNGAM(
            config.d,
            config.chunk,
            config.window_chunks,
            lags=config.lags,
            config=config.fit,
            reanchor_every=config.reanchor_every,
            device=device,
        )
        self._chunks_since_refit = 0
        self.n_refits = 0
        self.n_chunks = 0
        self.last_fit: Optional[window_lib.RollingFit] = None
        self.last_delta: Optional[GraphDelta] = None
        self._prev_adjacency: Optional[np.ndarray] = None
        # Monotonic timestamp of the post that made this session due
        # (None while not due).
        self._due_since: Optional[float] = None
        # Adaptive cadence: current refit interval in chunks. Fixed at
        # refit_every unless coast_max > 0 (see apply_fit).
        self._cadence = config.refit_every
        mc = config.monitor
        self.monitor: Optional[monitor_lib.GraphHealthMonitor] = (
            monitor_lib.GraphHealthMonitor(mc, config.d, config.lags,
                                           sid=sid)
            if mc is not None else None
        )
        # pending: alerts not yet answered by a refit (drives `due`);
        # unread: alerts not yet collected through the engine's
        # poll_alerts; history: everything, for review.
        cap = mc.max_pending if mc else 1
        hist = mc.history if mc else 1
        self.pending_alerts: BoundedRing = BoundedRing(cap)
        self.unread_alerts: BoundedRing = BoundedRing(cap)
        self.alert_history: BoundedRing = BoundedRing(hist)

    def post(self, rows) -> bool:
        """Absorb one chunk; returns True when a refit is now due.

        When a monitor is armed, the chunk's moment summary (the one the
        window's slide computed: monitoring adds no data pass) is scored
        against the served graph; fired alerts land in the session's
        alert rings and make it due.
        """
        with obs_trace.span("stream.absorb", sid=self.sid) as sp:
            chunk_state = self.rolling.push(rows)
            if obs_trace.enabled():
                sp.set(rows=len(rows))
        self.n_chunks += 1
        if self.rolling.ready:
            self._chunks_since_refit += 1
        if self.monitor is not None and self.monitor.armed:
            self.absorb_alerts(self.monitor.update(
                chunk_state,
                chunk_index=self.n_chunks,
                refit_index=self.n_refits,
            ))
        obs_metrics.inc("stream.chunks", sid=self.sid)
        obs_metrics.gauge("stream.staleness_chunks", self._chunks_since_refit,
                          sid=self.sid)
        if self.due and self._due_since is None:
            self._due_since = time.monotonic()
        return self.due

    def absorb_alerts(self, alerts) -> None:
        """File fired alerts; an alert resets any coasting cadence."""
        for a in alerts:
            self.pending_alerts.append(a)
            self.unread_alerts.append(a)
            self.alert_history.append(a)
        if alerts:
            self._cadence = self.config.refit_every
            obs_metrics.gauge("stream.cadence_chunks", self._cadence,
                              sid=self.sid)

    def due_wait_s(self, now: Optional[float] = None) -> Optional[float]:
        """Seconds this session has been due without a refit (None when
        not due)."""
        if self._due_since is None:
            return None
        return (time.monotonic() if now is None else now) - self._due_since

    @property
    def cadence(self) -> int:
        """Current refit interval in chunks (adaptive when coasting)."""
        return self._cadence

    @property
    def due(self) -> bool:
        return self.rolling.ready and (
            bool(self.pending_alerts)
            or self._chunks_since_refit >= self._cadence
        )

    def apply_fit(self, fit: window_lib.RollingFit) -> GraphDelta:
        """Record a completed refit; returns the delta against the
        previous estimate (thresholded at ``config.delta_threshold``).

        Closes out pending alerts (they triggered this refit and travel
        on the delta), re-arms the monitor on the fresh estimate, and
        advances the adaptive cadence: stable alert-free refits double the
        interval (up to ``coast_max``); anything else resets it.
        """
        triggered = list(self.pending_alerts.drain())
        drift_score = (
            self.monitor.max_score()
            if self.monitor is not None and self.monitor.armed else 0.0
        )
        b0 = fit.result.adjacency.cpu().numpy()
        delta = graph_delta(
            self._prev_adjacency, b0, self.config.delta_threshold,
            self.n_refits,
        )
        delta.drift_score = drift_score
        delta.triggered_by = "alert" if triggered else "cadence"
        delta.alerts = triggered
        self._prev_adjacency = b0
        self.last_fit = fit
        self.last_delta = delta
        self.n_refits += 1
        self._chunks_since_refit = 0
        self._due_since = None
        if self.monitor is not None:
            self.monitor.arm(fit)
        if self.config.coast_max > 0:
            # The monitor's drift level is calibrated to the served model,
            # while raw adjacency deltas fluctuate with estimation noise;
            # unmonitored sessions fall back to the delta.
            stable = not triggered and (
                drift_score < 0.5 if self.monitor is not None
                else delta.max_abs_change <= self.config.delta_threshold
            )
            self._cadence = (
                min(self._cadence * 2, self.config.coast_max) if stable
                else self.config.refit_every
            )
            obs_metrics.gauge("stream.cadence_chunks", self._cadence,
                              sid=self.sid)
        obs_metrics.inc("stream.refits", sid=self.sid)
        obs_metrics.inc("stream.refits_by_trigger", trigger=delta.triggered_by,
                        sid=self.sid)
        obs_metrics.gauge("stream.staleness_chunks", 0, sid=self.sid)
        return delta

    def refit_now(self) -> GraphDelta:
        """Single-session refit path."""
        return self.apply_fit(self.rolling.refit())


def bucket_key(
    session: StreamSession, plan: window_lib.RefitPlan
) -> Tuple[Tuple[int, ...], api.FitConfig]:
    """Batched-execution bucket: identical residual shapes + identical
    (hashable) fit configs share one batched refit."""
    return tuple(plan.resid.shape), session.rolling.config


__all__: List[str] = [
    "GraphDelta",
    "StreamConfig",
    "StreamSession",
    "bucket_key",
    "graph_delta",
]
