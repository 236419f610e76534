"""Batched causal-discovery serving engine on the card.

``CausalDiscoveryEngine`` serves DirectLiNGAM traffic. Fit requests are
grouped by (m, d) shape and run through the batched engine
(:func:`repro_torch.core.batched.fit_many`): a group of up to
``batch_size`` requests is one batched fit, one moment-kernel launch per
ordering step for all of them.

The engine also admits *streaming* sessions (``open_stream`` /
``post_chunk`` / ``flush_streams``): each session owns a rolling-window
VarLiNGAM over the incremental moment store
(:mod:`repro_torch.stream`); posted chunks advance the window in
O(chunk d^2), and due refits across sessions are grouped by (residual
shape, fit config) and run through
:func:`repro_torch.core.batched.fit_many_from_stats`: a burst of due
windows costs one batched refit, one row-tile kernel launch per ordering
step for all of them, and each client gets back a
:class:`~repro_torch.stream.session.GraphDelta`. Monitored sessions
(:mod:`repro_torch.stream.monitor`) score every chunk against the served
graph; drift alerts make a session due at once, ride out on its next
delta, and are collected through :meth:`CausalDiscoveryEngine.poll_alerts`.

Fitted and streaming graphs are *queryable*: ``query`` admits a mixed
micro-batch of effect, intervention and root-cause requests
(:mod:`repro_torch.infer.query`); stream-session ids resolve to the
session's live estimate.

A session's failed refit never aborts a flush: it is recorded as a
:class:`FlushError` in ``last_flush_errors``, the remaining sessions
proceed, and the failed session stays due for retry.

Deliberate differences from the reference: fit, flush and query groups
hold the real requests only (the reference pads them to a power of two
to bound its compiles; the port has no compile cache), with
``batch_size`` as the cap; a due window whose refit inputs are not
finite (non-finite rows posted to it) is held out of the batched refit
and reported as a ``"prepare"`` flush error; results of ``run`` are
numpy arrays on the host, as the reference's; and the engine runs on
``device``, the card unless the caller asks for ``"cpu"``.

A config with a ``partition`` is served by the mesh plan
(:mod:`repro_torch.core.sharded`): each request is one ``api.fit_fn``
over the mesh, all of a ``run`` call's requests inside one
``launch.mesh.mesh_scope`` (a world of one set up for the call when no
process group exists). Batched fits and stream refits stay on the local
plan, as in the reference.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import api as lingam_api
from repro_torch.core import batched as lingam_batched
from repro_torch.infer import query as query_lib
from repro_torch.kernels.tune import autotune as ktune_autotune
from repro_torch.launch import mesh as launch_mesh
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.ring import BoundedRing
from repro_torch.stream import monitor as monitor_lib
from repro_torch.stream import session as stream_session
from repro_torch.stream import window as stream_window


@dataclasses.dataclass
class FitRequest:
    """One causal-discovery request: a dataset to fit."""

    data: np.ndarray  # (m, d) float32
    result: Optional[lingam_api.FitResult] = None  # numpy fields on return


@dataclasses.dataclass
class FlushError:
    """One session's failed refit during :meth:`CausalDiscoveryEngine.
    flush_streams`, surfaced as data instead of aborting the flush.

    ``stage`` names where the failure happened: ``"prepare"`` (the
    session's refit plan could not be built, or its inputs are not
    finite), ``"fit"`` (the batched, or fallback per-session, fit raised),
    or ``"finish"`` (the lagged-coefficient finish or the delta). A failed
    session keeps its due state, so the next post or flush retries it.
    """

    sid: str            # "*" for a whole-bucket failure
    stage: str          # "prepare" | "fit" | "finish"
    bucket: Optional[Tuple[Tuple[int, ...], lingam_api.FitConfig]]
    error: Exception

    def summary(self) -> str:
        shape = None if self.bucket is None else self.bucket[0]
        return (
            f"flush error [{self.stage}] session={self.sid} "
            f"bucket={shape}: {type(self.error).__name__}: {self.error}"
        )


class CausalDiscoveryEngine:
    """Micro-batched DirectLiNGAM serving over the functional core, on
    ``device`` (the card unless the caller asks for ``"cpu"``; raises
    without a card).

    Requests with the same (m, d) shape share batched fits of up to
    ``batch_size`` datasets. Streaming traffic is the second regime:
    ``open_stream`` admits a session, ``post_chunk`` advances its rolling
    window (no fit), and due refits are batched across sessions on flush
    through ``fit_many_from_stats``. ``post_chunk`` auto-flushes once a
    full micro-batch of sessions is due.

    ``warmup(shapes)`` resolves the kernels' launch plans (running the
    autotuner's timed search when the mode is ``"auto"``) and runs one
    fit for each expected dataset shape, so first requests pay neither a
    plan search nor the kernels' build.
    """

    def __init__(self, config: Optional[lingam_api.FitConfig] = None,
                 *, batch_size: int = 8,
                 warmup_shapes: Optional[List[Tuple[int, int]]] = None,
                 device="cuda"):
        self.config = config or lingam_api.FitConfig(compaction="staged")
        self.device = lingam_api.resolve_device(device)
        self.batch_size = batch_size
        self._streams: Dict[str, stream_session.StreamSession] = {}
        self._next_sid = 0
        # Errors from the most recent flush_streams call; empty means
        # every due refit landed. Bounded.
        self.last_flush_errors: BoundedRing = BoundedRing(256)
        self.queries = query_lib.QueryEngine(batch_size=batch_size,
                                             device=self.device)
        if warmup_shapes:
            self.warmup(warmup_shapes)

    def warmup(
        self,
        shapes: List[Tuple[int, int]],
        *,
        tune_mode: Optional[str] = None,
        compile: bool = True,
        streams: Sequence[stream_session.StreamConfig] = (),
    ) -> Dict[str, object]:
        """Resolve the kernels' launch plans for the (m, d) dataset shapes
        (and the windows of the ``streams`` configurations) this engine
        expects, at its batch size, and with ``compile`` run one fit of
        each shape (which builds the kernels at first use).

        With ``tune_mode="auto"`` (or ``FitConfig(tune="auto")``) the plan
        search runs *now*, per shape bucket, and persists to the local
        tuning overlay, so neither fit requests nor batched refits pay a
        first-request search. Returns the plans by tuning-table key.
        """
        mode = tune_mode or self.config.tune
        warm_ops = ("pairwise_moments",) if (
            self.config.moment_chunk is None
        ) else ("pairwise_moments", "pairwise_moment_sums_chunked")
        plans = ktune_autotune.warmup_plans(
            shapes, ops=warm_ops, backend=self.config.backend, mode=mode,
            chunk=self.config.moment_chunk, batch=self.batch_size,
            device=self.device,
        )
        for sc in streams:
            plans.update(ktune_autotune.warmup_plans(
                [(sc.chunk * sc.window_chunks, sc.d)],
                ops=("pairwise_moment_sums_chunked",),
                backend=sc.fit.backend, mode=mode,
                chunk=sc.fit.moment_chunk or sc.chunk,
                batch=self.batch_size, device=self.device,
            ))
        if compile and self.config.partition is None:
            for shape in shapes:
                lingam_batched.warmup_fit_many(shape, self.config,
                                               device=self.device)
        return plans

    def run(self, requests: List[FitRequest]) -> List[FitRequest]:
        """Fit every request, grouped by shape into batched fits of up to
        ``batch_size`` (with a partition: one mesh fit each); each
        request's ``result`` is set to a :class:`FitResult` of numpy
        arrays."""
        with obs_trace.span("serve.run", n=len(requests)):
            if self.config.partition is not None:
                self._run_mesh(requests)
            else:
                by_shape: Dict[Tuple[int, ...], List[FitRequest]] = {}
                for r in requests:
                    by_shape.setdefault(np.shape(r.data), []).append(r)
                for shape, group in by_shape.items():
                    for start in range(0, len(group), self.batch_size):
                        self._run_fit_bucket(
                            shape, group[start:start + self.batch_size])
            obs_metrics.inc("serve.fit_requests", len(requests))
        return requests

    def _run_mesh(self, requests: List[FitRequest]) -> None:
        """Mesh plan: one ``api.fit_fn`` over the mesh per request, all in
        one mesh scope (the reference's ``_run_mesh``)."""
        with launch_mesh.mesh_scope(self.config.partition.mesh,
                                    self.device.type):
            for r in requests:
                x = torch.as_tensor(
                    np.ascontiguousarray(r.data, dtype=np.float32),
                    device=self.device)
                order, adj, rv = lingam_api.fit_fn(x, self.config).to_numpy()
                r.result = lingam_api.FitResult(
                    order=order, adjacency=adj, resid_var=rv)

    def _run_fit_bucket(self, shape, part: List[FitRequest]) -> None:
        with obs_trace.span("serve.fit_bucket", shape=shape, n=len(part)):
            t0 = time.perf_counter()
            # Row-major like the facades' input (simulated data is
            # Fortran ordered, and np.stack keeps that layout).
            xs = torch.as_tensor(np.stack([
                np.ascontiguousarray(r.data, dtype=np.float32)
                for r in part]), device=self.device)
            order, adj, rv = lingam_batched.fit_many(
                xs, self.config).to_numpy()
            for i, r in enumerate(part):
                r.result = lingam_api.FitResult(
                    order=order[i], adjacency=adj[i], resid_var=rv[i])
            obs_metrics.observe("serve.bucket_fill",
                                len(part) / self.batch_size, kind="fit")
            obs_metrics.observe("serve.fit_bucket_s",
                                time.perf_counter() - t0,
                                m=shape[0], d=shape[1])

    # ------------------------------------------------------------------
    # Streaming sessions
    # ------------------------------------------------------------------

    def open_stream(self, config: stream_session.StreamConfig) -> str:
        """Admit a streaming session; returns its session id."""
        sid = f"stream-{self._next_sid}"
        self._next_sid += 1
        self._streams[sid] = stream_session.StreamSession(
            sid, config, device=self.device)
        return sid

    def post_chunk(
        self, sid: str, rows
    ) -> List[Tuple[str, stream_session.GraphDelta]]:
        """Advance a session's window by one chunk (O(chunk d^2), no fit).

        Auto-flushes, returning (sid, delta) pairs, once a full
        micro-batch of sessions is due, counting only sessions whose
        windows are full (a still-filling session cannot become due
        without its own posts, so it must not starve the active ones). A
        due refit is deferred at most one of its session's own posts
        waiting for peers: if this session was already due *before* this
        post, the flush happens now. Returns [] when nothing flushed
        (:meth:`flush_streams` forces pending refits out)."""
        session = self._streams[sid]
        was_due = session.due
        session.post(rows)
        n_due = sum(1 for s in self._streams.values() if s.due)
        n_ready = sum(1 for s in self._streams.values() if s.rolling.ready)
        if n_due and (was_due or n_due >= min(self.batch_size, n_ready)):
            return self.flush_streams()
        if session.due:
            # Left due, waiting for peers: the one-post deferral.
            obs_metrics.inc("serve.flush_deferrals", sid=sid)
        return []

    def flush_streams(self) -> List[Tuple[str, stream_session.GraphDelta]]:
        """Run every due session's refit, batched.

        Due sessions' :class:`~repro_torch.stream.window.RefitPlan`\\ s are
        grouped by (residual shape, fit config); each group runs in parts
        of up to ``batch_size`` sessions, each part one
        ``fit_many_from_stats`` call.

        A failing session does **not** abort the flush: its error is
        recorded as a :class:`FlushError` in ``last_flush_errors``, the
        remaining sessions proceed, and the failed session stays due. A
        whole-part failure falls back to per-session ``refit_now``, so one
        poisoned plan cannot starve its peers.
        """
        self.last_flush_errors.clear()
        t_flush = time.perf_counter()
        due = [(sid, s) for sid, s in self._streams.items() if s.due]
        out: List[Tuple[str, stream_session.GraphDelta]] = []
        with obs_trace.span("serve.flush", n_due=len(due)):
            if obs_trace.enabled():
                now = time.monotonic()
                for _, s in due:
                    waited = s.due_wait_s(now)
                    if waited is not None:
                        obs_metrics.observe("serve.queue_wait_s", waited)
            prepared = []
            for sid, s in due:
                try:
                    with obs_trace.span("stream.prepare", sid=sid):
                        plan = s.rolling.prepare_refit()
                    prepared.append((sid, s, plan))
                except Exception as e:  # noqa: BLE001 - surfaced as data
                    self._flush_error(sid, "prepare", None, e)
            # One device-to-host copy tells which windows hold non-finite
            # values; those are held out of the batch (they would fit to
            # NaN).
            finite = torch.stack([
                torch.isfinite(p.resid).all()
                & torch.isfinite(p.resid_cov).all()
                for _, _, p in prepared]).cpu().tolist() if prepared else []
            buckets: Dict[object, List] = {}
            for (sid, s, plan), ok in zip(prepared, finite):
                if not ok:
                    self._flush_error(sid, "prepare", None, ValueError(
                        "the window's refit inputs are not finite"))
                    continue
                key = stream_session.bucket_key(s, plan)
                buckets.setdefault(key, []).append((sid, s, plan))
            for (shape, config), group in buckets.items():
                for start in range(0, len(group), self.batch_size):
                    part = group[start:start + self.batch_size]
                    out.extend(self._flush_bucket(shape, config, part))
            obs_metrics.observe("serve.flush_s", time.perf_counter() - t_flush)
            obs_metrics.inc("serve.flushes")
        return out

    def _flush_bucket(
        self, shape, config, part
    ) -> List[Tuple[str, stream_session.GraphDelta]]:
        """One ``fit_many_from_stats`` call over a part of due sessions,
        with per-session error isolation."""
        out: List[Tuple[str, stream_session.GraphDelta]] = []
        with obs_trace.span("serve.flush_bucket", shape=shape, n=len(part)):
            obs_metrics.observe("serve.bucket_fill",
                                len(part) / self.batch_size, kind="flush")
            try:
                results = lingam_batched.fit_many_from_stats(
                    torch.stack([p.resid for _, _, p in part]),
                    torch.stack([p.resid_mean for _, _, p in part]),
                    torch.stack([p.resid_cov for _, _, p in part]),
                    config,
                ).unbind()
            except Exception as e:  # noqa: BLE001 - surfaced as data
                self._flush_error("*", "fit", (shape, config), e)
                for sid, s, _ in part:
                    try:
                        out.append((sid, s.refit_now()))
                    except Exception as e2:  # noqa: BLE001
                        self._flush_error(sid, "fit", (shape, config), e2)
                return out
            for (sid, s, plan), result in zip(part, results):
                try:
                    with obs_trace.span("stream.finish", sid=sid):
                        fit = stream_window.finish_refit(plan, result)
                        out.append((sid, s.apply_fit(fit)))
                except Exception as e:  # noqa: BLE001
                    self._flush_error(sid, "finish", (shape, config), e)
        return out

    def _flush_error(self, sid, stage, bucket, error) -> None:
        self.last_flush_errors.append(
            FlushError(sid=sid, stage=stage, bucket=bucket, error=error))
        obs_metrics.inc("serve.flush_errors", sid=sid, stage=stage)

    # ------------------------------------------------------------------
    # Causal queries (effects / interventions / RCA)
    # ------------------------------------------------------------------

    def query(self, queries: List[object]) -> List[object]:
        """Answer a micro-batch of causal queries against fitted graphs.

        Accepts a mixed list of :class:`repro_torch.infer.query.
        EffectQuery` / ``InterventionQuery`` / ``RCAQuery``. Each
        request's ``graph`` may be a :class:`~repro_torch.infer.query.
        FittedGraph`, a bare :class:`~repro_torch.core.api.FitResult`
        (wrapped with centered-data defaults), or a *stream session id*,
        resolved here to the session's current estimate with moments
        from its incremental store. Session-backed graphs are
        re-snapshotted from the live session on every call, so a
        re-issued query object sees the current estimate.
        """
        with obs_trace.span("serve.query", n=len(queries)):
            for q in queries:
                sid = (
                    q.graph if isinstance(q.graph, str)
                    else getattr(q.graph, "sid", None)
                )
                if sid is not None:
                    q.graph = query_lib.FittedGraph.from_session(
                        self._streams[sid])
            return self.queries.run(queries)

    def poll_alerts(
        self, sid: Optional[str] = None
    ) -> List[monitor_lib.DriftAlert]:
        """Drain unread drift alerts, oldest first.

        ``sid`` scopes the drain to one session; None collects across
        every admitted session. Each alert is delivered exactly once
        here; the session's bounded ``alert_history`` keeps a copy, and
        alerts that *triggered* a refit also travel on that refit's
        :class:`~repro_torch.stream.session.GraphDelta`.
        """
        sessions = (
            [self._streams[sid]] if sid is not None
            else list(self._streams.values())
        )
        out: List[monitor_lib.DriftAlert] = []
        for s in sessions:
            out.extend(s.unread_alerts.drain())
        if out:
            obs_metrics.inc("serve.alerts_polled", len(out))
        return out

    def stream_session(self, sid: str) -> stream_session.StreamSession:
        """The live session object (last_fit / last_delta / state)."""
        return self._streams[sid]

    def close_stream(self, sid: str) -> stream_session.StreamSession:
        """Retire a session, returning its final state."""
        return self._streams.pop(sid)
