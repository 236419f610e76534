"""Rolling-window VarLiNGAM over the incremental moment store.

Consecutive analysis windows of a time series share almost all of their
rows, so the window slides in *chunks*:

  * :class:`ChunkRing` -- fixed-capacity ring of (chunk, d) numpy row
    blocks on the host; pushing into a full ring evicts (and returns)
    the oldest block.
  * :class:`RollingVarLiNGAM` -- keeps a :class:`~repro_torch.stream.
    stats.MomentState` on ``device`` over the window's *lag-augmented*
    rows ``[x_t, x_{t-1}, ..., x_{t-k}]``: each slide absorbs the new
    chunk's augmented rows and retracts the expired one's (O(chunk d^2)).
    A refit then reads the data only where it must:

      - VAR(k) coefficients come from the merged covariance blocks (one
        (kd, kd) solve, no lstsq over the window);
      - VAR residuals are formed chunk by chunk (one small product per
        live block);
      - the DirectLiNGAM step runs through ``api.fit_from_stats`` with
        the residual mean/covariance derived from the same state; only
        the nonlinear ordering moments re-read the rows, over
        ``FitConfig.moment_chunk`` sample slabs (one row-tile kernel
        launch per ordering step on the card, over all the slabs).

:func:`direct_window_fit` is the from-scratch oracle: the identical
estimator from a direct two-pass over the whole window (no merges, no
retractions).
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import List, Optional

import numpy as np
import torch

from repro_torch.core import api

from . import stats

_RIDGE = 1e-6


def _tuned_moment_chunk(d: int, chunk: int, window_chunks: int,
                        config: api.FitConfig, device) -> int:
    """Default ordering-moment slab of a rolling window: the stream chunk.

    The reference asks its dispatcher for a tuned sample block bounded
    by the stream chunk. The port's plans carry no sample block: the slab
    is the session's memory bound and each slab's split plan depends on
    its length alone (what keeps a pair's sums equal at every buffer
    width), so it is not tuned. The dispatch still resolves the window's
    launch plan here, ahead of the first refit: with ``tune="auto"`` a
    missing bucket is measured now, not inside a refit.
    """
    from repro_torch.kernels import tune as ktune

    ktune.dispatch(
        "pairwise_moment_sums_chunked",
        (chunk * window_chunks, d),
        backend=config.backend,
        mode=config.tune,
        chunk=chunk,
        device=device,
    )
    return chunk


def lagged_rows(buf: np.ndarray, lags: int) -> np.ndarray:
    """Lag-augmented rows of a contiguous (n, d) block.

    Row t (for t in [lags, n)) is ``[x_t, x_{t-1}, ..., x_{t-lags}]``,
    shape (n - lags, (lags + 1) d): the first ``lags`` rows of ``buf``
    serve only as history. A chunk pushed with its predecessor's
    ``lags``-row tail therefore contributes exactly ``chunk`` augmented
    rows; the stream's very first chunk contributes ``chunk - lags``.
    """
    n = buf.shape[0]
    if n <= lags:
        raise ValueError(f"need more than lags={lags} rows, got {n}")
    return np.concatenate(
        [buf[lags - tau:n - tau] for tau in range(lags + 1)], axis=1
    )


class ChunkRing:
    """Fixed-capacity FIFO ring of (chunk, d) row blocks.

    ``push`` returns the evicted oldest block once the ring is full
    (None before that). Iteration runs oldest -> newest.
    """

    def __init__(self, capacity: int):
        if capacity < 2:
            raise ValueError(f"ring needs >= 2 chunks, got {capacity}")
        self.capacity = capacity
        self._blocks: deque = deque()

    def push(self, rows: np.ndarray) -> Optional[np.ndarray]:
        self._blocks.append(rows)
        if len(self._blocks) > self.capacity:
            return self._blocks.popleft()
        return None

    @property
    def full(self) -> bool:
        return len(self._blocks) == self.capacity

    def __len__(self) -> int:
        return len(self._blocks)

    def __iter__(self):
        return iter(self._blocks)


def _var_solve(count, mean, m2, *, d: int, lags: int):
    """VAR(k) + residual stats from augmented-row moments.

    The augmented covariance's blocks are the normal equations of the
    windowed regression y = x_t on z = [x_(t-1), ..., x_(t-k)] with
    intercept: A = Cov(y, z) Cov(z, z)^-1 (tiny ridge for safety),
    intercept = mean_y - A mean_z, Cov(resid) = Cov(y) - A Cov(z, y)
    (exact at the solution; the residual mean is 0 by construction).
    Returns (a, mats, intercept, resid_cov) with ``a`` the (d, k d)
    stacked coefficient rows and ``mats`` its [k, d, d] per-lag view.
    """
    cov = m2 / torch.clamp(count, min=1.0)
    szz = cov[d:, d:]
    szy = cov[d:, :d]
    ridge = _RIDGE * torch.diagonal(szz).mean() + 1e-30
    szz = szz + ridge * torch.eye(szz.shape[0], dtype=szz.dtype,
                                  device=szz.device)
    a = torch.linalg.solve(szz, szy).T  # (d, k d)
    intercept = mean[:d] - a @ mean[d:]
    mats = a.reshape(d, lags, d).permute(1, 0, 2)  # [k, d, d]
    resid_cov = cov[:d, :d] - a @ szy
    resid_cov = 0.5 * (resid_cov + resid_cov.T)
    return a, mats, intercept, resid_cov


def _residual_block(aug, a, intercept):
    """VAR residuals of one augmented block: y - intercept - z A^T."""
    d = intercept.shape[0]
    return aug[:, :d] - intercept[None, :] - aug[:, d:] @ a.T


@dataclasses.dataclass
class RefitPlan:
    """One due refit, ready to run: the window's VAR residuals plus the
    moment-derived statistics ``fit_from_stats`` consumes."""

    resid: torch.Tensor       # (m_aug, d) window VAR residuals
    resid_mean: torch.Tensor  # (d,) zeros -- exact with the intercept
    resid_cov: torch.Tensor   # (d, d) state-derived residual covariance
    mats: np.ndarray          # [k, d, d] VAR coefficient matrices
    intercept: np.ndarray     # (d,)


@dataclasses.dataclass
class RollingFit:
    """One window's estimate: the instantaneous fit + lagged thetas."""

    result: api.FitResult       # order/adjacency(B0)/resid_var
    thetas: List[np.ndarray]    # [theta_0 (= B0), theta_1, ..., theta_k]
    var_coefs: np.ndarray       # [k, d, d] raw VAR coefficients
    n_rows: int                 # augmented rows in the window
    intercept: Optional[np.ndarray] = None  # (d,) VAR intercept


def finish_refit(plan: RefitPlan, result: api.FitResult) -> RollingFit:
    """Lagged-coefficient transform theta_tau = (I - B0) M_tau."""
    b0 = result.adjacency.cpu().numpy()
    eye = np.eye(b0.shape[0], dtype=b0.dtype)
    mats = np.asarray(plan.mats)
    thetas = [b0] + [(eye - b0) @ mats[tau] for tau in range(mats.shape[0])]
    return RollingFit(
        result=result,
        thetas=thetas,
        var_coefs=mats,
        n_rows=int(plan.resid.shape[0]),
        intercept=np.asarray(plan.intercept),
    )


def _plan(state, bufs, *, d, lags, device) -> RefitPlan:
    """The refit inputs from an augmented-row state and the window's
    lag-context blocks."""
    a, mats, intercept, resid_cov = _var_solve(
        state.count, state.mean, state.m2, d=d, lags=lags)
    blocks = [
        _residual_block(torch.as_tensor(lagged_rows(buf, lags),
                                        device=device), a, intercept)
        for buf in bufs
    ]
    return RefitPlan(
        resid=torch.cat(blocks, dim=0),
        resid_mean=torch.zeros((d,), dtype=torch.float32, device=device),
        resid_cov=resid_cov,
        mats=mats.cpu().numpy(),
        intercept=intercept.cpu().numpy(),
    )


class RollingVarLiNGAM:
    """Incremental VarLiNGAM over a chunked rolling window.

    Args:
      d:             number of variables.
      chunk:         rows per pushed block (must exceed ``lags``).
      window_chunks: window length in chunks (ring capacity).
      lags:          VAR order k.
      config:        the DirectLiNGAM :class:`~repro_torch.core.api.
                     FitConfig` for the residual fit; ``moment_chunk``
                     defaults to the stream chunk (the session's memory
                     bound; see :func:`_tuned_moment_chunk`), so the
                     ordering moments accumulate over chunk-sized sample
                     slabs.
      reanchor_every: if > 0, rebuild the moment state from the live
                     ring every that-many slides (after the window fills)
                     to cap retraction drift on non-stationary streams.
      device:        where the moment state, the residuals and the fit
                     live (default the CUDA card; raises without one).
                     The ring keeps its blocks on the host.
    """

    def __init__(
        self,
        d: int,
        chunk: int,
        window_chunks: int,
        *,
        lags: int = 1,
        config: api.FitConfig = api.FitConfig(compaction="staged"),
        reanchor_every: int = 0,
        device="cuda",
    ):
        if lags < 1:
            raise ValueError(f"lags must be >= 1, got {lags}")
        if chunk <= lags:
            raise ValueError(f"chunk ({chunk}) must exceed lags ({lags})")
        self.device = api.resolve_device(device)
        self.d = d
        self.chunk = chunk
        self.lags = lags
        self.reanchor_every = reanchor_every
        if config.moment_chunk is None:
            config = dataclasses.replace(
                config, moment_chunk=_tuned_moment_chunk(
                    d, chunk, window_chunks, config, self.device))
        self.config = config
        self.ring = ChunkRing(window_chunks)
        self.aug_state = stats.init((lags + 1) * d, device=self.device)
        self._prev_tail: Optional[np.ndarray] = None  # newest chunk's tail
        self._lead_tail: Optional[np.ndarray] = None  # rows before oldest
        self.n_pushed = 0

    @property
    def ready(self) -> bool:
        """Whether a full window is buffered (refits allowed)."""
        return self.ring.full

    def _augmented(self, buf):
        return torch.as_tensor(lagged_rows(buf, self.lags), device=self.device)

    def push(self, rows) -> stats.MomentState:
        """Slide the window by one chunk: absorb ``rows``' augmented
        moments, retract the evicted chunk's. Returns the absorbed
        chunk's own augmented state. Raises ``ValueError`` on rows of the
        wrong shape or with a non-finite value, leaving the window as it
        was (the reference absorbs NaN, and its window stays non-finite
        after the chunk's eviction)."""
        # Copy unconditionally: the ring and tails hold these rows until
        # retraction, so aliasing a caller-reused buffer would corrupt
        # the window.
        rows = np.array(rows, dtype=np.float32, copy=True)
        if rows.shape != (self.chunk, self.d):
            raise ValueError(
                f"expected ({self.chunk}, {self.d}) rows, got {rows.shape}"
            )
        # A non-finite value would enter aug_state for good: the retract
        # of its chunk cannot remove it. Refuse it before any state moves.
        if not np.isfinite(rows).all():
            raise ValueError("rows hold a non-finite value (NaN or inf)")
        buf = rows if self._prev_tail is None else np.concatenate(
            [self._prev_tail, rows]
        )
        chunk_state = stats.from_chunk(self._augmented(buf))
        self.aug_state = stats.merge(self.aug_state, chunk_state)
        evicted = self.ring.push(rows)
        if evicted is not None:
            ebuf = evicted if self._lead_tail is None else np.concatenate(
                [self._lead_tail, evicted]
            )
            self.aug_state = stats.retract(
                self.aug_state, stats.from_chunk(self._augmented(ebuf)))
            self._lead_tail = evicted[-self.lags:]
        self._prev_tail = rows[-self.lags:]
        self.n_pushed += 1
        if (
            self.reanchor_every
            and self.ring.full
            and self.n_pushed % self.reanchor_every == 0
        ):
            self.reanchor()
        return chunk_state

    def _window_bufs(self):
        """Live blocks with their lag context, oldest -> newest."""
        tail = self._lead_tail
        for block in self.ring:
            yield block if tail is None else np.concatenate([tail, block])
            tail = block[-self.lags:]

    def reanchor(self) -> None:
        """Rebuild the moment state from the live ring (drops all
        accumulated merge/retract rounding)."""
        state = stats.init((self.lags + 1) * self.d, device=self.device)
        for buf in self._window_bufs():
            state = stats.merge(state, stats.from_chunk(self._augmented(buf)))
        self.aug_state = state

    def load_state(self, blocks, lead_tail, prev_tail, n_pushed,
                   aug_state) -> None:
        """Rebuild this window from another implementation's state.

        Args:
          blocks:    the live ring blocks, oldest -> newest, each a
                     (chunk, d) array (at most ``window_chunks``).
          lead_tail: the ``lags`` rows before the oldest block, or None.
          prev_tail: the newest block's last ``lags`` rows, or None.
          n_pushed:  chunks pushed so far (drives ``reanchor_every``).
          aug_state: (count, mean, m2) of the augmented-row moments.
        The reference's ``RollingVarLiNGAM`` holds these as ``ring``,
        ``_lead_tail``, ``_prev_tail``, ``n_pushed`` and ``aug_state``.
        """
        blocks = [np.array(b, dtype=np.float32, copy=True) for b in blocks]
        if len(blocks) > self.ring.capacity:
            raise ValueError(
                f"{len(blocks)} blocks for a ring of {self.ring.capacity}"
            )
        for b in blocks:
            if b.shape != (self.chunk, self.d):
                raise ValueError(
                    f"expected ({self.chunk}, {self.d}) blocks, got {b.shape}"
                )
        width = (self.lags + 1) * self.d
        count, mean, m2 = aug_state
        if np.shape(mean) != (width,) or np.shape(m2) != (width, width):
            raise ValueError(
                f"aug_state must be over {width} augmented columns"
            )

        def tail(t):
            return None if t is None else np.array(t, dtype=np.float32,
                                                   copy=True)

        self.ring = ChunkRing(self.ring.capacity)
        for b in blocks:
            self.ring.push(b)
        self._lead_tail = tail(lead_tail)
        self._prev_tail = tail(prev_tail)
        self.n_pushed = int(n_pushed)
        self.aug_state = stats.MomentState.from_numpy(
            count, mean, m2, device=self.device)

    def prepare_refit(self) -> RefitPlan:
        """Assemble this window's refit inputs (state-derived VAR +
        chunk-wise residual blocks)."""
        if not self.ready:
            raise RuntimeError(
                f"window not full: {len(self.ring)}/{self.ring.capacity} "
                "chunks buffered"
            )
        return _plan(self.aug_state, self._window_bufs(), d=self.d,
                     lags=self.lags, device=self.device)

    def refit(self) -> RollingFit:
        """Re-estimate the current window's graph."""
        plan = self.prepare_refit()
        result = api.fit_from_stats(
            plan.resid, plan.resid_mean, plan.resid_cov, self.config
        )
        return finish_refit(plan, result)


def direct_window_plan(chunks, lead_tail, *, lags: int = 1,
                       device="cuda") -> RefitPlan:
    """The refit inputs of :func:`direct_window_fit`: augmented rows built
    in one piece and their moments from one two-pass, with no merges or
    retractions."""
    device = api.resolve_device(device)
    chunks = [np.ascontiguousarray(c, dtype=np.float32) for c in chunks]
    d = chunks[0].shape[1]
    buf = np.concatenate(
        ([lead_tail] if lead_tail is not None else []) + chunks
    )
    state = stats.from_chunk(
        torch.as_tensor(lagged_rows(buf, lags), device=device))
    return _plan(state, [buf], d=d, lags=lags, device=device)


def direct_window_fit(
    chunks,
    lead_tail,
    *,
    lags: int = 1,
    config: api.FitConfig = api.FitConfig(compaction="staged"),
    device="cuda",
) -> RollingFit:
    """From-scratch oracle: the identical estimator via a direct
    two-pass over the whole window. The rolling path must agree with
    this within float32 merge tolerance."""
    plan = direct_window_plan(chunks, lead_tail, lags=lags, device=device)
    result = api.fit_from_stats(
        plan.resid, plan.resid_mean, plan.resid_cov, config
    )
    return finish_refit(plan, result)
