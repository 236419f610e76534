"""Causal-query throughput on the port: batched micro-batches against a
per-query loop -> BENCH_torch_infer.json.

    PYTHONPATH=src python3 -m benchmarks.torch_run --only infer [--full]

The reference bench (``benchmarks/bench_infer.py``) on the card. For
each (d, kind):

  * **loop**: one request at a time through
    :class:`repro_torch.infer.query.QueryEngine`, the per-query serving
    baseline (bucketing, host-to-device copies, the solve, the answer
    back on the host);
  * **batched**: the same requests in one ``QueryEngine.run`` (one
    batched triangular solve per bucket);
  * **loop_kernel** (effects only): the bare per-query computation,
    :func:`repro_torch.infer.effects.total_effects_impl` on one graph,
    with a device synchronize after each: the compute floor (the
    reference's jitted ``total_effects_impl``).

Cells: total-effect queries at d in {64, 256}, and root-cause queries
at d = 64 with 256 rows each. No moment kernel runs here: the queries
are matrix solves and products (cuBLAS/cuSOLVER through torch). Warm-up
passes run outside the timed window; each timed pass ends in a device
synchronize. Each row also holds the batched answers against the
loop's (``max_rel_diff_batched_vs_loop``: max |batched - loop| over
max(1, max |loop|) per answer; a batched and a single triangular solve
round differently).
"""

from __future__ import annotations

import numpy as np

from repro_torch.core import api
from repro_torch.infer import effects, query

from benchmarks.torch_common import clock, launch_counts, launches_since, sync


def _synthetic_graphs(d: int, n: int, seed: int, device):
    """n fitted-graph stand-ins: random strictly-lower-triangular (in a
    random order) adjacencies, as the reference bench draws them."""
    rng = np.random.default_rng(seed)
    graphs = []
    for _ in range(n):
        perm = rng.permutation(d).astype(np.int32)
        b_ord = np.tril(rng.normal(size=(d, d)) * 0.3, k=-1)
        inv = np.empty(d, dtype=np.int32)
        inv[perm] = np.arange(d, dtype=np.int32)
        b = b_ord[np.ix_(inv, inv)].astype(np.float32)
        graphs.append(api.FitResult.from_numpy(perm, b, np.ones(d, np.float32),
                                               device=device))
    return graphs


def _time(fn, repeats: int, device) -> float:
    best = float("inf")
    for _ in range(repeats):
        t0 = clock(device)
        fn()
        best = min(best, clock(device) - t0)
    return best


def _max_diff(got, want) -> float:
    """max over answers of max |got - want| / max(1, max |want|)."""
    return max(float(np.abs(g - w).max()) / max(1.0, float(np.abs(w).max()))
               for g, w in zip(got, want))


def run(quick: bool = True, device="cuda"):
    device = api.resolve_device(device)
    dims = (64, 256)
    n_queries = 32 if quick else 64
    repeats = 3 if quick else 5
    before = launch_counts()
    rows = []
    for d in dims:
        graphs = _synthetic_graphs(d, n_queries, seed=d, device=device)
        engine = query.QueryEngine(batch_size=n_queries, device=device)

        def loop():
            return [engine.run([query.EffectQuery(graph=g)])[0].effects
                    for g in graphs]

        def loop_kernel():
            for g in graphs:
                effects.total_effects_impl(g.adjacency, g.order)
                sync(device)

        def batched():
            return [q.effects for q in engine.run(
                [query.EffectQuery(graph=g) for g in graphs])]

        # Warm every path outside the timed window.
        effects.total_effects_impl(graphs[0].adjacency, graphs[0].order)
        want, got = loop(), batched()
        t_loop = _time(loop, repeats, device)
        t_kernel = _time(loop_kernel, repeats, device)
        t_batched = _time(batched, repeats, device)
        speedup = t_loop / t_batched
        rows.append({
            "kind": "effects", "d": d, "n_queries": n_queries,
            "loop_s": t_loop, "loop_kernel_s": t_kernel,
            "batched_s": t_batched,
            "per_query_us_loop": 1e6 * t_loop / n_queries,
            "per_query_us_batched": 1e6 * t_batched / n_queries,
            "speedup": speedup,
            "max_rel_diff_batched_vs_loop": _max_diff(got, want),
        })
        print(f"torch_infer,kind=effects,d={d},n={n_queries},"
              f"loop_s={t_loop:.4f},kernel_s={t_kernel:.4f},"
              f"batched_s={t_batched:.4f},speedup={speedup:.2f}")

    # RCA cell: attribution of a row batch per request.
    d, n_rows = 64, 256
    graphs = _synthetic_graphs(d, n_queries, seed=1, device=device)
    sample_rows = [
        np.random.default_rng(i).normal(size=(n_rows, d)).astype(np.float32)
        for i in range(n_queries)
    ]
    engine = query.QueryEngine(batch_size=n_queries, device=device)

    def rca_queries():
        return [query.RCAQuery(graph=g, rows=r, target=0)
                for g, r in zip(graphs, sample_rows)]

    def rca_loop():
        return [engine.run([q])[0].result.scores for q in rca_queries()]

    def rca_batched():
        return [q.result.scores for q in engine.run(rca_queries())]

    want, got = rca_loop(), rca_batched()  # warm both buckets
    t_loop = _time(rca_loop, repeats, device)
    t_batched = _time(rca_batched, repeats, device)
    rows.append({
        "kind": "rca", "d": d, "n_queries": n_queries, "n_rows": n_rows,
        "loop_s": t_loop, "batched_s": t_batched,
        "per_query_us_loop": 1e6 * t_loop / n_queries,
        "per_query_us_batched": 1e6 * t_batched / n_queries,
        "speedup": t_loop / t_batched,
        "max_rel_diff_batched_vs_loop": _max_diff(got, want),
    })
    print(f"torch_infer,kind=rca,d={d},n={n_queries},rows={n_rows},"
          f"loop_s={t_loop:.4f},batched_s={t_batched:.4f},"
          f"speedup={t_loop / t_batched:.2f}")

    return {
        "device": str(device),
        "rows": rows,
        "speedup_effects": {str(r["d"]): r["speedup"]
                            for r in rows if r["kind"] == "effects"},
        "launches": launches_since(before),
    }
