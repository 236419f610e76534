"""Timed launch-plan search: candidates -> bit check -> timings -> table.

The candidates of an op are its heuristic plan and one plan per
pair-block edge of ``pairwise_stats.TILES``, the only tunable field (see
the bit-parity contract in :mod:`repro_torch.kernels.tune.registry`).
The search runs each candidate once through the real wrappers (an
explicit ``plan``, so dispatch is bypassed, not re-entered) on synthetic
standardized data of the bucket's shape (raw data with its mean and 1/std
for the fused kernel B3, whose one fixed plan is measured as it is: it
has nothing tunable), checks that every candidate's
sums are bit-identical to the heuristic plan's, then times each one
(:func:`measure_plan`: on the card the device time of back-to-back runs
queued behind a device sleep, so a small kernel is timed without the
host's launch gaps; on the CPU the host clock, where every candidate
runs the same plain version and the search only exercises the table) and
records the fastest in the tuning table under its bucketed key, for
``dispatch(mode="cache")`` to hit without measuring again.

    python3 -m repro_torch.kernels.tune.autotune [--out PATH]

on a card writes the committed defaults (``--out`` defaults to
``default_plans.json``): for each bucket that the single-launch fit paths
reach (``lingam-1m-100``, ``varlingam-stocks-487`` and the rolling refit
of ``varlingam-stream-487``, each at the widths d .. 2, a few of them a
bucket: :func:`fit_path_cells`), the pair-block edge with the least time
over the bucket's widths, each weighted by the launches it stands for.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.obs import compile_log
from repro_torch.obs import profile as obs_profile
from repro_torch.obs import trace as obs_trace

from . import cache as tune_cache
from . import registry


@dataclasses.dataclass
class Measurement:
    plan: registry.Plan
    seconds: float


@dataclasses.dataclass
class TunePlan:
    """One bucket's measured decision."""

    key: str
    op: str
    dtype: str
    backend: str
    device_kind: str
    shape: Tuple[int, ...]
    batch: int
    best: registry.Plan
    measurements: List[Measurement]

    def to_row(self) -> dict:
        """JSON row: the decision and every candidate's time, with its
        achieved rate and share of the roofline where the analytic cost
        model covers the op (:func:`repro_torch.obs.profile.analytic_cost`
        against the card's peaks)."""
        cost = obs_profile.analytic_cost(self.op, self.shape,
                                         batch=self.batch)
        peaks = obs_profile.device_peaks(self.device_kind)

        def cand_row(m: Measurement) -> dict:
            row = {**m.plan.to_entry(), "source": m.plan.source,
                   "ms": m.seconds * 1e3}
            if cost is not None:
                u = obs_profile.utilization(cost["flops"], cost["bytes"],
                                            m.seconds, peaks, cost["unit"])
                row["gflops_per_s"] = u["gflops_per_s"]
                row["roofline_frac"] = u["roofline_frac"]
            return row

        return {
            "key": self.key,
            "op": self.op,
            "shape": list(self.shape),
            "batch": self.batch,
            "device_kind": self.device_kind,
            "best": self.best.to_entry(),
            "candidates": [cand_row(m) for m in self.measurements],
        }


def candidate_plans(
    op: str,
    shape,
    *,
    backend: Optional[str] = None,
    chunk: Optional[int] = None,
    batch: int = 1,
    device="cuda",
) -> List[registry.Plan]:
    """The heuristic plan first, then one candidate per admissible
    pair-block edge (none for a variant with nothing tunable)."""
    variant = registry.get_variant(op, registry.resolve_backend(backend))
    heur = registry.dispatch_heuristic(op, shape, backend=variant.backend,
                                       chunk=chunk, batch=batch,
                                       device=device)
    plans = [heur]
    if "tile" in variant.constraints.tunable:
        plans += [dataclasses.replace(heur, tile=t, source="candidate")
                  for t in variant.constraints.tiles if t != heur.tile]
    return plans


def _bench_inputs(shape, batch: int, device, seed: int = 0):
    """Standardized (m, d) data and its correlation, or a batch of them,
    on ``device``."""
    from .. import ops

    m, d = (shape[2], shape[1]) if len(shape) == 3 else shape
    rng = np.random.default_rng(seed)
    xs = []
    for _ in range(batch):
        x = torch.from_numpy(rng.laplace(size=(m, d)).astype(np.float32))
        xs.append(ops.standardize(x.to(device)))
    cs = [ops.correlation(x) for x in xs]
    if batch == 1:
        return xs[0].contiguous(), cs[0].contiguous()
    return torch.stack(xs), torch.stack(cs)


def fused_bench_inputs(shape, device, seed: int = 0):
    """Kernel B3's inputs for a (tile, d, m) shape, on ``device``: raw
    (m, d) data, its per-variable mean and 1/std (ddof=0), and the
    correlation of the data they standardize, as the reference's
    autotuner builds them."""
    from .. import ops

    _, d, m = shape
    rng = np.random.default_rng(seed)
    x_raw = torch.from_numpy(
        rng.laplace(size=(m, d)).astype(np.float32)).to(device)
    mu = x_raw.mean(dim=0)
    rstd = 1.0 / x_raw.std(dim=0, unbiased=False).clamp_min(1e-12)
    c = ops.correlation((x_raw - mu) * rstd).contiguous()
    return x_raw, mu, rstd, c


def _bench_fn(op: str, shape, chunk, batch: int, device):
    """``run(plan) -> (S1, S2)`` for one op on inputs built once."""
    from .. import ops

    if op == "fused_moment_sums":
        # B3 has nothing tunable: its one plan is the fixed "cuda-fused"
        # launch, which on a CPU tensor runs the plain version.
        if batch != 1:
            raise ValueError("kernel B3 has no batch axis")
        x_raw, mu, rstd, c = fused_bench_inputs(shape, device)
        return lambda plan: ops.fused_moment_rows(x_raw, mu, rstd, c, 0,
                                                  shape[0])
    x, c = _bench_inputs(shape, batch, device)

    def backend(plan):  # the CUDA variant's wrappers take CPU tensors too
        return None if plan.backend == "cuda" else plan.backend

    if op == "pairwise_moments":
        return lambda plan: ops.pairwise_moments(
            x, c, backend=backend(plan), plan=plan)
    if op == "pairwise_moment_sums_rows":
        return lambda plan: ops.pairwise_moment_sums_rows(
            x, c, 0, shape[0], backend=backend(plan), plan=plan)
    if op == "pairwise_moment_sums_chunked":
        return lambda plan: ops.pairwise_moment_sums_chunked(
            x, c, chunk=chunk or x.shape[-2], backend=backend(plan),
            plan=plan)
    raise ValueError(f"no benchmark runner for op {op!r}")


_SLEEP_CYCLES = 200_000_000  # ~0.1 s of a card: time to enqueue the runs


def measure_plan(run, plan, *, repeats: int = 10, device="cuda") -> float:
    """Seconds per run of ``run(plan)`` after one untimed run. On the
    card: CUDA events around ``repeats`` back-to-back runs queued behind a
    device sleep, over ``repeats`` (the kernels' time without the host's
    launch gaps). On the CPU: the least host time of ``repeats`` runs."""
    run(plan)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(_SLEEP_CYCLES)
        e0.record()
        for _ in range(repeats):
            run(plan)
        e1.record()
        e1.synchronize()
        return e0.elapsed_time(e1) * 1e-3 / repeats
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        run(plan)
        best = min(best, time.perf_counter() - t0)
    return best


def measure_candidates(run, plans, *, repeats: int = 10,
                       device="cuda") -> List[Measurement]:
    """Check that every plan's sums equal the first plan's (the heuristic
    one) bit for bit, then time each with :func:`measure_plan`. Raises
    on a difference, before anything is timed."""
    want = run(plans[0])
    for p in plans[1:]:
        got = run(p)
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise RuntimeError(
                f"plan {p} changes the sums of the heuristic plan "
                f"{plans[0]}")
    return [Measurement(plan=p, seconds=measure_plan(
        run, p, repeats=repeats, device=device)) for p in plans]


def autotune_op(
    op: str,
    shape,
    *,
    dtype="float32",
    backend: Optional[str] = None,
    chunk: Optional[int] = None,
    batch: int = 1,
    repeats: int = 10,
    device="cuda",
    table: Optional[tune_cache.TuneTable] = None,
    persist: bool = True,
) -> TunePlan:
    """Check, time and record the candidates of one (op, shape, batch).

    Raises if any candidate's sums differ in a bit from the heuristic
    plan's: nothing is recorded then.
    """
    backend = registry.resolve_backend(backend)
    kind = registry.device_kind(device)
    t0 = time.perf_counter()
    with obs_trace.span("kernels.tune", op=op, shape=tuple(shape),
                        batch=batch):
        measurements = measure_candidates(
            _bench_fn(op, shape, chunk, batch, device),
            candidate_plans(op, shape, backend=backend, chunk=chunk,
                            batch=batch, device=device),
            repeats=repeats, device=device)
    compile_log.record("kernels.tune", shape=shape,
                       config=(op, backend, chunk, batch, kind),
                       seconds=time.perf_counter() - t0)
    best = dataclasses.replace(
        min(measurements, key=lambda m: m.seconds).plan, source="tuned")
    key = tune_cache.plan_key(kind, op, backend, registry.dtype_token(dtype),
                              tune_cache.shape_bucket(op, shape, batch))
    tbl = table if table is not None else tune_cache.get_table()
    if not tbl.offline:
        entry = best.to_entry()
        entry["time_us"] = min(m.seconds for m in measurements) * 1e6
        tbl.record(key, entry, persist=persist)
    return TunePlan(key=key, op=op, dtype=registry.dtype_token(dtype),
                    backend=backend, device_kind=kind, shape=tuple(shape),
                    batch=batch, best=best, measurements=measurements)


def warmup_plans(
    shapes: Sequence[Tuple[int, int]],
    *,
    ops: Sequence[str] = ("pairwise_moments",),
    backend: Optional[str] = None,
    mode: str = "cache",
    chunk: Optional[int] = None,
    batch: int = 1,
    device="cuda",
    table: Optional[tune_cache.TuneTable] = None,
) -> Dict[str, registry.Plan]:
    """Resolve (and, with ``mode="auto"``, measure and persist) the plans
    for the (m, d) dataset shapes an engine expects, at the launch's
    ``batch``: the hook ``CausalDiscoveryEngine.warmup`` calls so first
    requests never pay a search. Returns the plans by table key."""
    backend = registry.resolve_backend(backend)
    kind = registry.device_kind(device)
    out: Dict[str, registry.Plan] = {}
    for (m, d) in shapes:
        for op in ops:
            shape = (m, d) if op in (
                "pairwise_moments", "pairwise_moment_sums_chunked"
            ) else (d, d, m)
            # The fit path's clamp (ops.pairwise_moment_sums_chunked bounds
            # the slab by the sample count), so warm-up resolves the plan
            # the first request will ask for.
            chunk_eff = max(1, min(chunk, m)) if chunk else chunk
            plan = registry.dispatch(
                op, shape, backend=backend, mode=mode, chunk=chunk_eff,
                batch=batch, device=device, table=table,
            )
            key = tune_cache.plan_key(
                kind, op, plan.backend, "float32",
                tune_cache.shape_bucket(op, shape, batch),
            )
            out[key] = plan
    return out


WIDTHS_PER_BUCKET = 4


def fit_path_cells():
    """{path: [(op, (m, w), chunk, launches per fit), ...]}: the launches
    of the three fit paths at the widths the local plan's ordering steps
    run at (``core.ordering.order_schedule``): B1 over ``lingam-1m-100``,
    B1 over the VAR residuals of ``varlingam-stocks-487`` (m - 1 rows),
    and B2 over the window of the rolling refit of
    ``varlingam-stream-487`` in its slabs. The widths of one table bucket
    (``cache.shape_bucket``) are split into up to ``WIDTHS_PER_BUCKET``
    runs of neighbours; each run is one cell, at its middle width, that
    stands for the run's launches. Widest first."""
    from repro_torch.configs.lingam_workloads import (STREAM_WORKLOADS,
                                                      WORKLOADS)
    from repro_torch.core.ordering import order_schedule

    lm, sv = WORKLOADS["lingam-1m-100"], WORKLOADS["varlingam-stocks-487"]
    sw = STREAM_WORKLOADS["varlingam-stream-487"]

    def path(op, m, d, chunk=None):
        buckets: Dict[str, List[Tuple[int, int]]] = {}
        for w, n in order_schedule(d):
            buckets.setdefault(tune_cache.shape_bucket(op, (m, w)),
                               []).append((w, n))
        cells = []
        for steps in buckets.values():
            k = min(WIDTHS_PER_BUCKET, len(steps))
            for i in range(k):
                run = steps[i * len(steps) // k:(i + 1) * len(steps) // k]
                cells.append((op, (m, run[len(run) // 2][0]), chunk,
                              sum(n for _, n in run)))
        return cells

    return {
        "lingam-1m-100": path("pairwise_moments", lm.m, lm.d),
        "varlingam-stocks-487": path("pairwise_moments", sv.m - 1, sv.d),
        "stream refit": path("pairwise_moment_sums_chunked",
                             sw.chunk * sw.window_chunks, sw.d, sw.chunk),
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=tune_cache._DEFAULT_PATH)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("the autotuner's table is measured on a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    buckets: Dict[str, Dict[int, float]] = {}  # key -> {tile: s per fit}
    launches: Dict[str, int] = {}
    for op, shape, chunk, n in (cell for cells in fit_path_cells().values()
                                for cell in cells):
        key = tune_cache.plan_key(registry.device_kind(), op, "cuda",
                                  "float32", tune_cache.shape_bucket(op, shape))
        ms = measure_candidates(_bench_fn(op, shape, chunk, 1, "cuda"),
                                candidate_plans(op, shape, chunk=chunk),
                                repeats=20)
        totals = buckets.setdefault(key, {})
        for m in ms:
            totals[m.plan.tile] = totals.get(m.plan.tile, 0.0) + n * m.seconds
        launches[key] = launches.get(key, 0) + n
        print(json.dumps({"op": op, "shape": list(shape), "launches": n,
                          "heuristic": ms[0].plan.tile,
                          "ms": {m.plan.tile: m.seconds * 1e3 for m in ms}}),
              flush=True)
    table = tune_cache.TuneTable(default_path="", overlay_path_=args.out)
    for key, totals in buckets.items():
        op = key.split("/")[2]
        tile = min(totals, key=totals.get)
        entry = registry.dispatch_heuristic(op, (1, 1)).to_entry()
        entry.update(tile=tile, time_us=totals[tile] / launches[key] * 1e6)
        table.record(key, entry, persist=False)
        print(json.dumps({"key": key, "tile": tile, "ms_per_fit": {
            t: v * 1e3 for t, v in totals.items()}}), flush=True)
    table.save_overlay()
    print(f"{len(buckets)} plans written to {args.out}; {card}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
