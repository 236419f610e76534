"""Causal discovery on stock-like time series (paper section 4.2, Fig. 4 /
Table 2), on the PyTorch/CUDA port.

    PYTHONPATH=src python3 examples/torch_stock_varlingam.py [--full]
        [--device cpu]
    PYTHONPATH=src python3 examples/torch_stock_varlingam.py --stream [--full]
    PYTHONPATH=src python3 examples/torch_stock_varlingam.py --drift [--full]

Default mode: VAR(1) + instantaneous LiNGAM graph on synthetic S&P-like
series (d=487 with --full). Prints degree-distribution stats and the
top-5 exerting / receiving indices by total causal effect.

``--stream`` mode: slides a chunked rolling window over the same panel
with the port's streaming layer (incremental moment store + rolling
VarLiNGAM, :mod:`repro_torch.stream`) and prints per-slide graph-delta
stats and the per-slide wall time.

``--drift`` mode: a regime change mid-stream through the port's serving
engine (:class:`repro_torch.serve.engine.CausalDiscoveryEngine`). A
monitored session coasts through the stationary stretch, then a
structural break (the strongest instantaneous edge rewired) fires drift
alerts that force a refit and name the broken variable.

Default and stream modes end by *querying* the fitted graph
(:mod:`repro_torch.infer`): the strongest total instantaneous effect, a
lag-propagated impulse response, and root-cause attribution of the most
anomalous recent sample.
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.core import VarLiNGAM, api  # noqa: E402
from repro_torch.data.simulate import (  # noqa: E402
    simulate_var_breaks,
    simulate_var_stocks,
)
from repro_torch.infer import effects, rca  # noqa: E402


def query_fitted_graph(result, var_coefs, rows, mean, device) -> None:
    """Effect + IRF + RCA queries against one fitted graph."""
    t = effects.total_effects(result).cpu().numpy()
    off = np.abs(t) * (1 - np.eye(t.shape[0]))
    i, j = np.unravel_index(np.argmax(off), t.shape)
    print(f"strongest total effect: x{j} -> x{i} = {t[i, j]:+.3f}")

    irf = effects.var_irf(result.adjacency, result.order, var_coefs,
                          horizon=3, device=device).cpu().numpy()
    print("shock persistence |IRF_h| (mean abs response to a unit "
          "shock):", [round(float(np.abs(h).mean()), 4) for h in irf])

    report = rca.attribute(result, rows, mean=mean)
    worst = int(np.argmax(np.abs(report.scores).max(axis=1)))
    print(f"RCA over {rows.shape[0]} recent samples: most anomalous "
          f"sample {worst}, implicated root x{report.root[worst]}, "
          f"ranking {report.ranking(row=worst, top_k=3)}")


def run_stream(full: bool, device: str) -> None:
    from repro_torch.stream import RollingVarLiNGAM, graph_delta

    d, chunk, window_chunks, n_slides = (
        (487, 256, 8, 2) if full else (32, 128, 4, 4)
    )
    lags = 1
    config = api.FitConfig(compaction="staged", moment_chunk=chunk)
    n_chunks = window_chunks + n_slides
    x, _, _ = simulate_var_stocks(m=chunk * n_chunks + 8, d=d, seed=0)

    roll = RollingVarLiNGAM(d, chunk, window_chunks, lags=lags,
                            config=config, device=device)
    prev = None
    print(
        f"streaming d={d}, chunk={chunk}, "
        f"window={window_chunks * chunk} rows, {n_slides} slides"
    )
    fit = None
    for k in range(n_chunks):
        roll.push(x[k * chunk:(k + 1) * chunk])
        if not roll.ready:
            continue
        t0 = time.time()
        fit = roll.refit()
        dt = time.time() - t0
        b0 = fit.result.adjacency.cpu().numpy()
        delta = graph_delta(prev, b0, 0.05, roll.n_pushed - window_chunks)
        prev = b0
        print(f"  {delta.summary()}  [{dt:.3f}s]")

    # End of stream: query the final rolling estimate (window-mean
    # baseline straight from the incremental moment store).
    print("\n=== querying the final rolling graph ===")
    win_mean = roll.aug_state.mean[:d].cpu().numpy()
    query_fitted_graph(
        fit.result, fit.var_coefs,
        x[(n_chunks - 1) * chunk:n_chunks * chunk][:16], win_mean, device,
    )


def run_drift(full: bool, device: str) -> None:
    """Regime-change demo: a monitored session across a structural break,
    served by the engine."""
    from repro_torch.serve.engine import CausalDiscoveryEngine
    from repro_torch.stream import MonitorConfig, StreamConfig

    d, chunk, window_chunks = (64, 200, 8) if full else (16, 100, 8)
    m = 6000 if not full else 10_000
    br = simulate_var_breaks(m=m, d=d, kind="edge_flip", seed=3, at=m // 2)
    print(
        f"regime change at row {br.at}: edge into x{br.variable} rewired "
        f"(d={d}, chunk={chunk}, window={window_chunks * chunk} rows)"
    )

    eng = CausalDiscoveryEngine(batch_size=1, device=device)
    sid = eng.open_stream(StreamConfig(
        d=d, chunk=chunk, window_chunks=window_chunks,
        refit_every=2, coast_max=32, monitor=MonitorConfig(),
    ))
    session = eng.stream_session(sid)
    break_chunk = br.at // chunk
    for ci, start in enumerate(range(0, (m // chunk) * chunk, chunk)):
        deltas = eng.post_chunk(sid, br.series[start:start + chunk])
        for _, delta in deltas:
            mark = " <-- post-break" if ci >= break_chunk else ""
            print(f"  chunk {ci:3d} cadence={session.cadence:2d} "
                  f"{delta.summary()}{mark}")
        for alert in eng.poll_alerts(sid):
            print(f"  chunk {ci:3d} ALERT {alert.summary()}")
    eng.flush_streams()
    hist = list(session.alert_history)
    detected = [a for a in hist if a.chunk_index > break_chunk]
    print(
        f"\n{len(hist)} alerts total; first post-break detection "
        + (f"{detected[0].chunk_index - break_chunk} chunk(s) after the "
           f"break, implicating x{detected[0].variable} "
           f"({detected[0].kind})" if detected else "never")
    )


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true", help="d=487 (paper scale)")
    ap.add_argument("--stream", action="store_true",
                    help="rolling-window streaming mode (per-slide deltas)")
    ap.add_argument("--drift", action="store_true",
                    help="regime change through the serving engine: drift "
                         "alerts + adaptive refit cadence")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args()
    if args.drift:
        run_drift(args.full, args.device)
        return
    if args.stream:
        run_stream(args.full, args.device)
        return
    from benchmarks.torch_stocks import run

    res = run(quick=not args.full, device=args.device)
    print("\nTop exerting nodes :", res["top_exerting"])
    print("Top receiving nodes:", res["top_receiving"])
    print("Leaf (holding-co-like) nodes:", res["leaf_nodes"])

    # Discovery done: now query the graph on a compact panel.
    print("\n=== querying a fitted VarLiNGAM graph ===")
    d = 487 if args.full else 32
    x, _, _ = simulate_var_stocks(m=1500, d=d, edge_prob=0.05, seed=0)
    model = VarLiNGAM(lags=1, prune_threshold=0.05,
                      device=args.device).fit(x)
    query_fitted_graph(model.result_, model.var_coefs_, x[-16:],
                       x.mean(axis=0), args.device)


if __name__ == "__main__":
    main()
