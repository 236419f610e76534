"""Graph-health monitoring on the port: detection delay, false alarms and
refit savings -> BENCH_torch_drift.json.

    PYTHONPATH=src python3 -m benchmarks.torch_run --only drift [--full]

The reference bench (``benchmarks/bench_drift.py``) on the card, on
simulated VAR(1) + LiNGAM streams with known structural breaks
(:func:`repro_torch.data.simulate.simulate_var_breaks`; ``--full``:
d = 32, 200-row chunks, m = 12,000, 5 seeds):

  * for each break kind (edge flip, weight shift, noise-scale change) a
    monitored session streams across the break: whether an alert fired
    after it, how many chunks later (the detection delay), and the
    false-alarm rate on the stationary stretch before it;
  * the same stationary stream served at a fixed cadence (a refit every
    ``refit_every`` chunks) and with adaptive coasting (the interval
    doubles while the monitor reads stable): the seconds spent in refits
    (host clock after a device synchronize) and their counts.

Every refit orders its window on the card with one B2 launch a step.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from repro_torch.core import api
from repro_torch.data.simulate import (BREAK_KINDS, simulate_var_breaks,
                                       simulate_var_stocks)
from repro_torch.stream import MonitorConfig, StreamConfig, StreamSession

from benchmarks.torch_common import clock, launch_counts, launches_since


def _stream_config(d, chunk, window_chunks, *, coast_max):
    return StreamConfig(d=d, chunk=chunk, window_chunks=window_chunks,
                        refit_every=2, coast_max=coast_max,
                        monitor=MonitorConfig())


def _run_break(series, at, cfg, device) -> Dict:
    """Stream one broken series: detection and false-alarm facts."""
    chunk = cfg.chunk
    s = StreamSession("bench", cfg, device=device)
    detect_chunk = None
    fired_kinds: List[str] = []
    false_alarm_chunks = 0
    pre_chunks = 0
    n = (series.shape[0] // chunk) * chunk
    for ci, start in enumerate(range(0, n, chunk)):
        due = s.post(series[start:start + chunk])
        post_break = start + chunk > at
        pending = list(s.pending_alerts)
        if not post_break and s.monitor.armed:
            pre_chunks += 1
            if pending:
                false_alarm_chunks += 1
        if pending and post_break and detect_chunk is None:
            detect_chunk = ci
            fired_kinds = sorted({a.kind for a in pending})
        if due:
            s.refit_now()
    return {
        "detected": detect_chunk is not None,
        "delay_chunks": (None if detect_chunk is None
                         else detect_chunk - at // chunk),
        "fired_kinds": fired_kinds,
        "false_alarm_chunks": false_alarm_chunks,
        "pre_chunks": pre_chunks,
    }


def _run_cadence(series, cfg, device) -> Dict:
    """Stream one stationary series: refit count and refit seconds."""
    chunk = cfg.chunk
    s = StreamSession("bench", cfg, device=device)
    refit_s = 0.0
    n = (series.shape[0] // chunk) * chunk
    for start in range(0, n, chunk):
        if s.post(series[start:start + chunk]):
            t0 = clock(device)
            s.refit_now()
            refit_s += clock(device) - t0
    return {"n_refits": s.n_refits, "refit_s": refit_s,
            "final_cadence": s.cadence, "alerts": len(s.alert_history)}


def run(quick: bool = True, device="cuda"):
    device = api.resolve_device(device)
    d = 12 if quick else 32
    chunk = 100 if quick else 200
    window_chunks = 8
    seeds = range(2) if quick else range(5)
    m = 6000 if quick else 12_000
    at = m // 2
    coast_max = 32
    before = launch_counts()

    # --- detection delay and false alarms per break kind --------------
    per_kind: Dict[str, Dict] = {}
    fa_chunks = 0
    pre_chunks = 0
    for kind in BREAK_KINDS:
        delays, hits, runs = [], 0, 0
        kinds_union: set = set()
        for seed in seeds:
            br = simulate_var_breaks(m=m, d=d, kind=kind, seed=seed, at=at)
            out = _run_break(br.series, br.at, _stream_config(
                d, chunk, window_chunks, coast_max=coast_max), device)
            runs += 1
            fa_chunks += out["false_alarm_chunks"]
            pre_chunks += out["pre_chunks"]
            if out["detected"]:
                hits += 1
                delays.append(out["delay_chunks"])
                kinds_union.update(out["fired_kinds"])
        per_kind[kind] = {
            "detection_rate": hits / runs,
            "detect_delay_chunks": (float(np.mean(delays)) if delays
                                    else None),
            "fired_kinds": sorted(kinds_union),
        }
    false_alarm_per_chunk = fa_chunks / max(pre_chunks, 1)

    # --- adaptive against fixed cadence on a stationary stream --------
    series = simulate_var_stocks(m=m, d=d, seed=7)[0]
    fixed = _run_cadence(series, _stream_config(
        d, chunk, window_chunks, coast_max=0), device)
    adaptive = _run_cadence(series, _stream_config(
        d, chunk, window_chunks, coast_max=coast_max), device)

    res = {
        "d": d,
        "chunk": chunk,
        "window_chunks": window_chunks,
        "runs_per_kind": len(seeds),
        "device": str(device),
        "per_kind": per_kind,
        "false_alarm_per_chunk": false_alarm_per_chunk,
        "fixed_refits": fixed["n_refits"],
        "adaptive_refits": adaptive["n_refits"],
        "adaptive_final_cadence": adaptive["final_cadence"],
        "adaptive_alerts_stationary": adaptive["alerts"],
        "fixed_refit_s": fixed["refit_s"],
        "adaptive_refit_s": adaptive["refit_s"],
        "speedup_adaptive_cadence": (fixed["refit_s"]
                                     / max(adaptive["refit_s"], 1e-9)),
        "launches": launches_since(before),
    }
    delays_csv = ";".join(f"{k}={per_kind[k]['detect_delay_chunks']}"
                          for k in BREAK_KINDS)
    print(
        f"torch_drift,d={d},chunk={chunk},delays[{delays_csv}],"
        f"fa_per_chunk={false_alarm_per_chunk:.4f},"
        f"refits_fixed={fixed['n_refits']},"
        f"refits_adaptive={adaptive['n_refits']},"
        f"refit_s_fixed={fixed['refit_s']:.3f},"
        f"refit_s_adaptive={adaptive['refit_s']:.3f},"
        f"speedup={res['speedup_adaptive_cadence']:.2f}x,"
        f"launches={res['launches']}"
    )
    return res
