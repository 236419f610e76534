"""Streaming sessions: per-client rolling state + graph deltas.

A :class:`StreamSession` wraps one :class:`~repro_torch.stream.window.
RollingVarLiNGAM`: clients post (chunk, d) row blocks, the session tracks
when a refit is *due* (window full and ``refit_every`` chunks absorbed
since the last estimate), and each completed refit is summarized as a
:class:`GraphDelta` against the session's previous adjacency.

``StreamSession.refit_now`` runs a refit directly; a serving engine
(not yet in the port) collects the due sessions and runs their refits.
Drift monitoring is not ported yet either: ``StreamConfig.monitor`` must
be None. With ``coast_max`` > 0 the refit cadence still adapts, by the
unmonitored rule: after a refit whose adjacency moved by at most
``delta_threshold``, the interval doubles up to ``coast_max`` chunks.
Alerts filed through :meth:`StreamSession.absorb_alerts` make a session
due at once and reset the cadence.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, List, Optional, Tuple

import numpy as np

from repro_torch.core import api
from repro_torch.obs.ring import BoundedRing

from . import window as window_lib


@dataclasses.dataclass(frozen=True)
class StreamConfig:
    """Static shape/cadence knobs of one streaming session.

    ``chunk`` rows arrive per post; ``window_chunks`` chunks form the
    rolling window; a refit is due every ``refit_every`` chunks once the
    window is full. ``delta_threshold`` binarizes adjacencies for the
    edge add/remove sets. ``reanchor_every`` (slides) caps moment-
    retraction drift on non-stationary streams (0 = never).

    ``monitor`` must be None: the drift monitor is not ported yet
    (ROADMAP queue A, item 10). ``coast_max`` enables the adaptive
    cadence described in the module docstring (0 = fixed cadence).
    """

    d: int
    chunk: int
    window_chunks: int
    lags: int = 1
    refit_every: int = 1
    delta_threshold: float = 0.05
    reanchor_every: int = 0
    fit: api.FitConfig = api.FitConfig(compaction="staged")
    monitor: Optional[Any] = None
    coast_max: int = 0

    def __post_init__(self):
        if self.monitor is not None:
            raise NotImplementedError(
                "the drift monitor is not ported yet (ROADMAP queue A, item "
                "10): StreamConfig.monitor must be None"
            )


@dataclasses.dataclass
class GraphDelta:
    """One refit's change against the session's previous estimate."""

    refit_index: int            # 0 for the first estimate of a session
    n_edges: int                # |{(i, j): |B0_ij| > threshold}| now
    added: np.ndarray           # (a, 2) int (i, j) edges newly above
    removed: np.ndarray         # (r, 2) int edges newly below
    max_abs_change: float       # max |B0_new - B0_prev| (0.0 on first)
    frob_change: float          # ||B0_new - B0_prev||_F (0.0 on first)
    triggered_by: str = "cadence"   # "cadence" | "alert"
    alerts: List[Any] = dataclasses.field(default_factory=list)

    def summary(self) -> str:
        base = (
            f"refit {self.refit_index}: edges={self.n_edges} "
            f"+{len(self.added)}/-{len(self.removed)} "
            f"max|dB|={self.max_abs_change:.4f} "
            f"frob(dB)={self.frob_change:.4f}"
        )
        if self.triggered_by == "alert":
            base += f" by=alert[{len(self.alerts)}]"
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
        # pending: alerts not yet answered by a refit (drives `due`);
        # unread: alerts not yet collected by a reader; history: all.
        self.pending_alerts: BoundedRing = BoundedRing(1)
        self.unread_alerts: BoundedRing = BoundedRing(1)
        self.alert_history: BoundedRing = BoundedRing(1)

    def post(self, rows) -> bool:
        """Absorb one chunk; returns True when a refit is now due."""
        self.rolling.push(rows)
        self.n_chunks += 1
        if self.rolling.ready:
            self._chunks_since_refit += 1
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

        Closes out pending alerts (they travel on the delta) and advances
        the adaptive cadence: alert-free refits whose adjacency moved by
        at most ``delta_threshold`` double the interval (up to
        ``coast_max``); anything else resets it.
        """
        triggered = list(self.pending_alerts.drain())
        b0 = fit.result.adjacency.cpu().numpy()
        delta = graph_delta(
            self._prev_adjacency, b0, self.config.delta_threshold,
            self.n_refits,
        )
        delta.triggered_by = "alert" if triggered else "cadence"
        delta.alerts = triggered
        self._prev_adjacency = b0
        self.last_fit = fit
        self.last_delta = delta
        self.n_refits += 1
        self._chunks_since_refit = 0
        self._due_since = None
        if self.config.coast_max > 0:
            stable = (not triggered and delta.max_abs_change
                      <= self.config.delta_threshold)
            self._cadence = (
                min(self._cadence * 2, self.config.coast_max) if stable
                else self.config.refit_every
            )
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
