"""Streaming rolling-window VarLiNGAM against from-scratch per-window
refits on the port -> BENCH_torch_stream.json.

    PYTHONPATH=src python3 -m benchmarks.torch_run --only stream [--full]

The reference bench (``benchmarks/bench_stream.py``) on the card. It
slides a chunked rolling window over synthetic S&P-like series (paper
section 4.2 shapes: d = 487, 256-row chunks, an 8-chunk window with
``--full``) through the serving engine's streaming sessions and times
three paths end to end:

  * **rolling**: the streaming subsystem (incremental moment update and
    retraction per slide, VAR from the merged covariance, the ordering's
    moments over ``moment_chunk`` slabs, which on the card is one B2
    launch per ordering step, staged compaction, pruning from the moment
    state, due refits batched across sessions);
  * **scratch**: the per-window refit of the ``VarLiNGAM`` facade's path
    (the port's QR ``estimate_var`` and ``fit_fn`` at the facade's
    defaults: the full masked scan, one B1 launch per step);
  * **scratch_same_config**: the same from-scratch pipeline with the
    streaming fit config, which isolates what the incremental
    statistics alone buy.

Every path runs its kernels (backend ``None``); each clock read follows
a device synchronize. Warm-up (the kernels' build, the tuner's plans,
the engine's first flushes) runs before the timed window. The last timed
window's rolling order is held against the scratch order: equal, or
parting only at a tie (:func:`benchmarks.torch_equivalence.parting_tie`
on the rolling residuals, with the scratch residuals as the other data).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import api, ordering
from repro_torch.core.var_lingam import estimate_var
from repro_torch.data.simulate import simulate_var_stocks
from repro_torch.serve.engine import CausalDiscoveryEngine
from repro_torch.stream import StreamConfig

from benchmarks.torch_common import clock, launch_counts, launches_since
from benchmarks.torch_equivalence import parting_tie


def sizes(quick: bool) -> dict:
    """The reference bench's sizes."""
    return {"d": 64 if quick else 487, "chunk": 128 if quick else 256,
            "window_chunks": 8, "lags": 1, "n_streams": 2,
            "n_slides": 3 if quick else 2}


def _scratch_window_fit(rows, lags, config, device):
    """The per-window pipeline: QR VAR on the window, then a whole fit
    of its residuals. Returns (result, thetas, residuals)."""
    x = torch.as_tensor(np.ascontiguousarray(rows, np.float32),
                        device=device)
    mats, _, resid = estimate_var(x, lags)
    result = api.fit_fn(resid, config)
    b0 = result.adjacency
    eye = torch.eye(b0.shape[0], dtype=b0.dtype, device=device)
    thetas = [b0] + [(eye - b0) @ mats[tau] for tau in range(lags)]
    return result, thetas, resid


def run(quick: bool = True, device="cuda"):
    device = api.resolve_device(device)
    sz = sizes(quick)
    d, chunk, window_chunks = sz["d"], sz["chunk"], sz["window_chunks"]
    lags, n_streams, n_slides = sz["lags"], sz["n_streams"], sz["n_slides"]
    stream_fit = api.FitConfig(compaction="staged", moment_chunk=chunk)
    scratch_fit = api.FitConfig()  # the facade's default plan
    cfg = StreamConfig(d=d, chunk=chunk, window_chunks=window_chunks,
                       lags=lags, refit_every=1, fit=stream_fit)
    n_warm = window_chunks + 2
    n_chunks = n_warm + n_slides
    series = [simulate_var_stocks(m=chunk * n_chunks + 8, d=d, seed=s)[0]
              for s in range(n_streams)]
    before = launch_counts()

    # --- rolling path through the engine (batched due refits) --------
    eng = CausalDiscoveryEngine(batch_size=n_streams, device=device)
    sids = [eng.open_stream(cfg) for _ in range(n_streams)]

    def post_round(k):
        out = []
        for sid, x in zip(sids, series):
            out += eng.post_chunk(sid, x[k * chunk:(k + 1) * chunk])
        return out

    # Warm-up: the kernels' build, the plans, the stream-head and
    # steady-state windows; then drain pending dues so the timed rounds
    # start phase-aligned (one batched flush per round).
    for k in range(n_warm):
        post_round(k)
    eng.flush_streams()

    rolling_launches = launch_counts()
    t0 = clock(device)
    deltas = []
    for j in range(n_slides):
        deltas += post_round(n_warm + j)
    rolling_per_slide = (clock(device) - t0) / (n_slides * n_streams)
    rolling_launches = launches_since(rolling_launches)
    if len(deltas) != n_slides * n_streams:
        raise RuntimeError(f"expected {n_slides * n_streams} deltas in the "
                           f"timed rounds, got {len(deltas)}")
    session = eng.stream_session(sids[0])
    last = session.last_fit

    # --- scratch paths on stream 0's timed windows -------------------
    def window_rows(j):
        # The `lags` rows before the window too, so that the scratch VAR
        # regresses exactly the window's rows (the rolling path keeps that
        # lag context in the ring's lead tail). Timed slide j's window is
        # chunks [n_warm + j - wc + 1, n_warm + j].
        start = (n_warm + 1 + j - window_chunks) * chunk
        return series[0][start - lags:start + window_chunks * chunk]

    _scratch_window_fit(window_rows(-1), lags, scratch_fit, device)  # warm
    t0 = clock(device)
    scratch = [_scratch_window_fit(window_rows(j), lags, scratch_fit, device)
               for j in range(n_slides)]
    scratch_per_window = (clock(device) - t0) / n_slides

    _scratch_window_fit(window_rows(-1), lags, stream_fit, device)  # warm
    t0 = clock(device)
    for j in range(n_slides):
        _scratch_window_fit(window_rows(j), lags, stream_fit, device)
    scratch_same_cfg = (clock(device) - t0) / n_slides

    # --- parity of the last timed window -----------------------------
    sc_result, _, sc_resid = scratch[-1]
    roll_order = last.result.order.cpu().numpy()
    sc_order = sc_result.order.cpu().numpy()
    order_match = bool(np.array_equal(roll_order, sc_order))
    adj_diff = float((last.result.adjacency.cpu()
                      - sc_result.adjacency.cpu()).abs().max())
    parting_step, parting_ratio = None, 0.0
    if not order_match:
        plan = session.rolling.prepare_refit()
        x_roll = api.standardize_from_stats(plan.resid, plan.resid_mean,
                                            plan.resid_cov)
        parting_step, parting_ratio = parting_tie(
            x_roll, roll_order, sc_order, ordering.LocalReducer(),
            x_other=sc_resid)

    res = {
        "d": d,
        "chunk": chunk,
        "window_chunks": window_chunks,
        "window_rows": window_chunks * chunk,
        "lags": lags,
        "streams": n_streams,
        "slides": n_slides,
        "device": str(device),
        "rolling_per_slide_s": rolling_per_slide,
        "scratch_per_window_s": scratch_per_window,
        "scratch_same_config_s": scratch_same_cfg,
        "speedup_vs_scratch": scratch_per_window / rolling_per_slide,
        "speedup_same_config": scratch_same_cfg / rolling_per_slide,
        "order_match_last_window": order_match,
        "parting_step_last_window": parting_step,
        "parting_gap_ratio_last_window": parting_ratio,
        "order_tie_or_match_last_window": order_match or parting_ratio <= 1.0,
        "adj_max_diff_last_window": adj_diff,
        "edges_last_window": int(session.last_delta.n_edges),
        "stream_fit": dataclasses.asdict(stream_fit),
        "rolling_launches": rolling_launches,
        "launches": launches_since(before),
    }
    print(
        f"torch_stream,d={d},window={window_chunks * chunk},chunk={chunk},"
        f"rolling={rolling_per_slide:.3f}s,"
        f"scratch={scratch_per_window:.3f}s,"
        f"same_cfg={scratch_same_cfg:.3f}s,"
        f"speedup={res['speedup_vs_scratch']:.2f}x,"
        f"speedup_same_cfg={res['speedup_same_config']:.2f}x,"
        f"order_match={order_match},parting_ratio={parting_ratio:.3f},"
        f"adj_max_diff={adj_diff:.2e},launches={res['launches']}"
    )
    return res
