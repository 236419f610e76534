"""Quickstart: causal discovery with the PyTorch/CUDA port on one card.

    PYTHONPATH=src python3 examples/torch_quickstart.py [--device cpu]
        [--telemetry] [--profile]

Simulates data from a known layered DAG (paper section 3.1 protocol),
runs the parallel DirectLiNGAM on the card, verifies it against the
sequential reference, compares the CUDA kernel backend with the plain
``"blocked"`` backend, prints the recovered adjacency, then *uses* the
graph: total-effect queries, a do-intervention, and root-cause
attribution of an anomalous sample (the full discovery -> query path).
``--device cpu`` runs everything on the CPU, where the kernel's plain
version takes the kernel's place.

With ``--telemetry`` the run also drives the serving engine (a fit
micro-batch, a streaming session through refit flushes, and causal
queries) with the port's observability layer on
(:mod:`repro_torch.obs`), then prints the span tree, the metrics
snapshot and the build/search log, and writes a Chrome trace under
``--telemetry-out``.

With ``--profile`` it runs the performance-accounting layer
(:mod:`repro_torch.obs.profile`): a profiled fit inside a
``torch.profiler`` window with the host spans mirrored onto it, the
stage-attribution table (seconds, operations, share of the roofline per
stage and kernel variant) and the cost records, writing the device trace
next to the host span trace under ``--profile-out``.
"""

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.baselines.sequential_lingam import (  # noqa: E402
    causal_order_sequential,
)
from repro_torch.core import (  # noqa: E402
    DirectLiNGAM,
    VarLiNGAM,
    api,
    batched,
)
from repro_torch.core.bootstrap import bootstrap_lingam  # noqa: E402
from repro_torch.data.simulate import (  # noqa: E402
    simulate_do,
    simulate_lingam,
    simulate_var_stocks,
)
from repro_torch.infer import effects, intervene, rca  # noqa: E402


def main(device: str) -> None:
    print("=== DirectLiNGAM (paper Algorithm 1, parallel) ===")
    gt = simulate_lingam(m=5_000, d=10, seed=0)
    model = DirectLiNGAM(prune_threshold=0.1, device=device).fit(gt.data)
    sequential = causal_order_sequential(gt.data)
    print("causal order :", model.causal_order_)
    print("sequential   :", sequential)
    agree = np.array_equal(model.causal_order_, sequential)
    print(f"parallel == sequential: {agree}")

    est = np.abs(model.adjacency_) > 0.1
    true = gt.adjacency != 0
    print(f"edges: true={true.sum()} recovered={est.sum()} "
          f"correct={np.sum(est & true)}")

    kernel = "cuda" if device == "cuda" else None
    print(f"\n=== moment backend {kernel!r} against 'blocked' ===")
    model_k = DirectLiNGAM(backend=kernel, device=device).fit(gt.data)
    model_b = DirectLiNGAM(backend="blocked", device=device).fit(gt.data)
    print(f"{kernel!r} order :", model_k.causal_order_)
    print("'blocked' order:", model_b.causal_order_)
    print("orders agree :", np.array_equal(model_k.causal_order_,
                                           model_b.causal_order_))

    print("\n=== Functional core: fit_fn + batched bootstrap ===")
    x = torch.as_tensor(gt.data, device=api.resolve_device(device))
    res = api.fit_fn(x.contiguous(), api.FitConfig())
    print("fit_fn order  :", res.order.cpu().numpy())
    print("resid_var[:4] :", res.resid_var[:4].cpu().numpy().round(3))

    boot = bootstrap_lingam(gt.data, n_sampling=10, threshold=0.1, seed=0,
                            strategy="vmap", device=device)
    print("stable edges (P>=0.8):",
          [(i, j, p) for i, j, p, _ in boot.stable_edges(0.8)][:5])

    # fit_many: one batched program fitting an ensemble of datasets.
    xs = torch.stack([
        torch.as_tensor(np.ascontiguousarray(
            simulate_lingam(m=2_000, d=10, seed=s).data))
        for s in range(4)
    ]).to(api.resolve_device(device))
    ens = batched.fit_many(xs, api.FitConfig(compaction="staged"))
    print("fit_many orders (4 datasets):")
    print(ens.order.cpu().numpy())

    print("\n=== VarLiNGAM (paper section 3.2) ===")
    xv, b0, _ = simulate_var_stocks(m=2_000, d=20, edge_prob=0.1, seed=1)
    var_model = VarLiNGAM(lags=1, prune_threshold=0.05,
                          device=device).fit(xv)
    th0 = var_model.adjacency_matrices_[0]
    tp = np.sum((np.abs(th0) > 0.05) & (b0 != 0))
    print(f"instantaneous edges: true={np.sum(b0 != 0)} "
          f"recovered-correct={tp}")

    print("\n=== Causal queries on the fitted graph (repro_torch.infer) ===")
    # Total effects: (I - B)^-1 by triangular solve in causal order.
    t = effects.total_effects(model.result_).cpu().numpy()
    off = np.abs(t) * (1 - np.eye(t.shape[0]))
    i, j = np.unravel_index(np.argmax(off), t.shape)
    print(f"strongest total effect: x{j} -> x{i} = {t[i, j]:+.3f} "
          f"(direct {model.adjacency_[i, j]:+.3f})")

    # Intervention: predicted do(x_j = +2) mean vs interventional sampling.
    mu_do, _ = intervene.interventional_moments(
        model.result_, {int(j): 2.0},
        mean=gt.data.mean(axis=0), cov=np.cov(gt.data.T, ddof=0),
    )
    mc = simulate_do(gt.adjacency, {int(j): 2.0}, m=20_000, seed=0)
    print(f"do(x{j}=2): predicted E[x{i}]={mu_do[i]:+.3f}  "
          f"Monte-Carlo={mc[:, i].mean():+.3f}")

    # Root-cause attribution: inject an anomaly into x_j's noise term
    # and ask the graph who broke.
    x_anom = gt.data[:1].copy()
    x_anom[0] += 4.0 * t[:, j]  # shift j's noise by +4, propagated
    report = rca.attribute(
        model.result_, x_anom, mean=gt.data.mean(axis=0), target=int(i)
    )
    print(f"RCA: implicated root = x{report.root[0]} (injected x{j}); "
          f"ranking {report.ranking(top_k=3)}")


def telemetry_demo(device: str, out_dir=None) -> None:
    """Drive dispatch -> ordering -> pruning -> serve flush -> query with
    telemetry on; print the span tree, metrics and build/search log.
    ``out_dir`` also receives ``trace_events.json`` (Chrome trace-event
    format) and ``metrics_snapshot.json``."""
    import json

    from repro_torch import obs
    from repro_torch.infer import query as query_lib
    from repro_torch.serve.engine import CausalDiscoveryEngine, FitRequest
    from repro_torch.stream.session import StreamConfig

    obs.enable()
    obs.reset_all()
    rng = np.random.default_rng(0)

    print("\n=== Telemetry: serving engine under observation ===")
    eng = CausalDiscoveryEngine(batch_size=4, device=device)
    eng.run([
        FitRequest(data=rng.normal(size=(256, 8)).astype(np.float32))
        for _ in range(3)
    ])
    sid = eng.open_stream(
        StreamConfig(d=6, chunk=32, window_chunks=4, refit_every=1))
    for _ in range(7):
        eng.post_chunk(sid, rng.normal(size=(32, 6)).astype(np.float32))
    eng.flush_streams()
    answered = eng.query([
        query_lib.EffectQuery(graph=sid),
        query_lib.InterventionQuery(graph=sid, do={0: 1.5}),
    ])
    print(f"stream {sid}: {eng.stream_session(sid).n_refits} refits, "
          f"{len(answered)} queries answered, "
          f"{len(eng.last_flush_errors)} flush errors")

    print("\n--- span tree (spans tagged [trace] ran while capturing) ---")
    print(obs.format_tree())
    print("--- metrics snapshot ---")
    print(json.dumps(obs.metrics.snapshot(), indent=1, sort_keys=True))
    print("--- builds and searches (op -> events) ---")
    for op, n in sorted(obs.compile_log.by_op().items()):
        print(f"  {op}: {n}")

    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)
        trace_path = obs.write_chrome_trace(
            os.path.join(out_dir, "trace_events.json"))
        metrics_path = os.path.join(out_dir, "metrics_snapshot.json")
        with open(metrics_path, "w") as f:
            json.dump(obs.metrics.snapshot(), f, indent=1, sort_keys=True)
        print(f"wrote {trace_path} (open in chrome://tracing or "
              f"ui.perfetto.dev) and {metrics_path}")


def profile_demo(device: str, out_dir=None) -> None:
    """Profiled fit + stage attribution + device trace (on the CPU, the
    plain path only: the CUDA kernel's row needs the card). ``out_dir``
    receives ``trace_events.json`` (host spans), ``device_trace/
    device_trace.json`` (the torch.profiler trace, host spans mirrored
    as record_function ranges) and ``profile_snapshot.json`` (the cost
    records and the card's peaks)."""
    import json

    from repro_torch import obs
    from repro_torch.analysis import report
    from repro_torch.obs import profile

    obs.enable()
    profile.enable()
    obs.reset_all()

    print("\n=== Profiling: cost records + roofline attribution ===")
    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)
        with profile.device_trace(os.path.join(out_dir, "device_trace")):
            payload = report.live_attribution(
                m=512, d=16, repeats=2, device=device,
                include_cuda=device == "cuda")
    else:
        payload = report.live_attribution(
            m=512, d=16, repeats=2, device=device,
            include_cuda=device == "cuda")
    print(report.render(payload))

    print("\n--- cost records ---")
    for rec in profile.records():
        print(f"  {rec.op} shape={rec.shape} ops={rec.flops:.3g} "
              f"bytes={rec.bytes_accessed:.3g} temp={rec.temp_bytes} "
              f"calls={rec.calls} best={rec.best_s * 1e3:.2f}ms")

    if out_dir is not None:
        trace_path = obs.write_chrome_trace(
            os.path.join(out_dir, "trace_events.json"))
        snap_path = os.path.join(out_dir, "profile_snapshot.json")
        with open(snap_path, "w") as f:
            json.dump(profile.snapshot(), f, indent=1)
        print(f"\nwrote {trace_path}, {snap_path}, and "
              f"{os.path.join(out_dir, 'device_trace')}/ (open both traces "
              f"in ui.perfetto.dev to line up host spans with kernels)")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the fits run (default: the card)")
    ap.add_argument("--telemetry", action="store_true",
                    help="run the serving/streaming demo with "
                         "repro_torch.obs enabled and print span tree + "
                         "metrics")
    ap.add_argument("--telemetry-out", type=str, default="telemetry_out",
                    help="directory for --telemetry artifacts "
                         "(chrome trace + metrics snapshot)")
    ap.add_argument("--profile", action="store_true",
                    help="run the profiled fit: stage-attribution table, "
                         "cost records, host + device trace")
    ap.add_argument("--profile-out", type=str, default="profile_out",
                    help="directory for --profile artifacts "
                         "(host trace, device trace, cost snapshot)")
    args = ap.parse_args()
    main(args.device)
    if args.telemetry:
        telemetry_demo(args.device, out_dir=args.telemetry_out)
    if args.profile:
        profile_demo(args.device, out_dir=args.profile_out)
