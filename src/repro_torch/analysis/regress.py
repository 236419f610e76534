"""BENCH regression tracker: diff the port's perf artifacts against a
baseline (the port's own copy of the reference's ``analysis/regress.py``;
standard library only).

The port's benchmark runner (``benchmarks/torch_run.py``) writes every
run to repo-root ``BENCH_torch_<stem>.json`` artifacts: the committed
perf trajectory. This module closes the loop: it loads those baselines,
obtains a *current* set (a fresh quick run on the card, or a directory
of pre-produced artifacts), extracts every timing/throughput metric from
both, and reports per-kernel / per-stage deltas with tolerance bands.
Any metric slower than ``--tol`` (with an absolute floor ``--min-abs``
on time metrics, so microsecond noise cannot fail a build) makes the
process exit nonzero.

Metric extraction is schema-driven, not artifact-specific: any numeric
leaf whose key ends in ``_s`` / ``_ms`` / ``_us`` (or is ``us``) is a
lower-is-better time; any key ending ``_per_s`` or starting
``speedup`` is a higher-is-better rate. Rows are labeled by their
identifying fields (op/bucket/kind/mesh/cell + shape), so the same row
matches across runs even if list order changes.

Usage::

  python -m repro_torch.analysis.regress --smoke    # validate committed
                                                    # artifacts, exit 0
  python -m repro_torch.analysis.regress            # fresh quick run on
                                                    # the card vs the
                                                    # committed baselines
  python -m repro_torch.analysis.regress --current-dir DIR --tol 0.3
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
from pathlib import Path
from typing import Dict, List, Optional, Tuple

_REPO_ROOT = Path(__file__).resolve().parents[3]

# Artifact stems this tracker knows how to regenerate (stem -> bench
# name in benchmarks.torch_run.BENCHES); artifacts are
# BENCH_torch_<stem>.json. The equivalence and NOTEARS benches measure
# accuracy (F1, SHD), not time, and are not tracked here.
STEM_TO_BENCH = {
    "bootstrap": "bootstrap",
    "sharded": "sharded",
    "stream": "stream",
    "kernels": "tune",
    "infer": "infer",
    "drift": "drift",
    "profile": "profile",
    "speedup": "speedup",
    "gene": "gene",
    "stocks": "stocks",
}
ARTIFACT_PREFIX = "BENCH_torch_"

# Row fields that identify a row across runs (never treated as metrics).
_ID_KEYS = ("op", "bucket", "cell", "kind", "mesh", "name", "backend",
            "variant", "m", "d", "n_queries", "n_sampling", "shape", "stage")
_SKIP_KEYS = {"bench", "quick", "timestamp", "provenance", "device_kind",
              "hardware",
              "n_candidates", "bi", "bj", "bm", "block",
              # cost-accounting fields: descriptive, not pass/fail perf
              # (utilization moves with the peaks registry, not the code)
              "flops", "bytes", "arg_bytes", "out_bytes", "temp_bytes",
              "vmem_model_bytes", "intensity", "roofline_frac", "device"}


def _direction(key: str) -> Optional[Tuple[str, float]]:
    """(direction, to_seconds_scale) for a metric key, None if not a
    tracked metric. Direction: "lower" (time) or "higher" (rate)."""
    if key.endswith("_per_s") or key.startswith("speedup"):
        return ("higher", 1.0)
    if key.endswith("_s"):
        return ("lower", 1.0)
    if key.endswith("_ms"):
        return ("lower", 1e-3)
    if key == "us" or key.endswith("_us") or "_us_" in key:
        return ("lower", 1e-6)
    return None


def _row_label(row: dict, idx: int) -> str:
    parts = []
    for k in _ID_KEYS:
        if k in row and not isinstance(row[k], dict):
            v = row[k]
            v = "x".join(str(s) for s in v) if isinstance(v, (list, tuple)) \
                else v
            parts.append(f"{k}={v}")
    return "[" + (",".join(parts) if parts else f"row{idx}") + "]"


def collect_metrics(payload, prefix: str = "") -> Dict[str, Tuple[str, float]]:
    """Flatten an artifact payload into {metric_path: (direction,
    value_in_canonical_units)} — times normalized to seconds."""
    out: Dict[str, Tuple[str, float]] = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                if k in _SKIP_KEYS or k in _ID_KEYS:
                    continue
                if isinstance(v, bool):
                    continue
                if isinstance(v, (int, float)):
                    d = _direction(k)
                    if d is not None and math.isfinite(v):
                        out[f"{path}{k}"] = (d[0], float(v) * d[1])
                elif isinstance(v, (dict, list)):
                    walk(v, f"{path}{k}.")
        elif isinstance(node, list):
            for i, row in enumerate(node):
                if isinstance(row, dict):
                    walk(row, f"{path[:-1]}{_row_label(row, i)}.")

    walk(payload, prefix)
    return out


@dataclasses.dataclass
class Delta:
    """One metric compared across baseline and current runs."""

    metric: str
    direction: str          # "lower" | "higher"
    base: Optional[float]
    cur: Optional[float]
    status: str = "ok"      # ok | improved | REGRESSED | new | missing
    ratio: Optional[float] = None   # cur/base


def compare(base: Dict[str, Tuple[str, float]],
            cur: Dict[str, Tuple[str, float]],
            *, tol: float, min_abs: float) -> List[Delta]:
    """Per-metric deltas. A lower-is-better metric regresses when it is
    both ``tol`` relatively slower *and* ``min_abs`` seconds absolutely
    slower; a rate regresses on the relative band alone."""
    deltas: List[Delta] = []
    for metric in sorted(set(base) | set(cur)):
        bd, cd = base.get(metric), cur.get(metric)
        if bd is None:
            deltas.append(Delta(metric, cd[0], None, cd[1], status="new"))
            continue
        if cd is None:
            deltas.append(Delta(metric, bd[0], bd[1], None, status="missing"))
            continue
        direction, b = bd
        _, c = cd
        ratio = c / b if b else float("inf")
        d = Delta(metric, direction, b, c, ratio=ratio)
        if direction == "lower":
            if c > b * (1.0 + tol) and (c - b) > min_abs:
                d.status = "REGRESSED"
            elif c < b * (1.0 - tol):
                d.status = "improved"
        else:
            if c < b * (1.0 - tol):
                d.status = "REGRESSED"
            elif c > b * (1.0 + tol):
                d.status = "improved"
        deltas.append(d)
    return deltas


def load_artifacts(root: Path, stems) -> Dict[str, dict]:
    """{stem: payload} for every BENCH_torch_<stem>.json present in
    root."""
    out = {}
    for stem in stems:
        p = root / f"{ARTIFACT_PREFIX}{stem}.json"
        if p.exists():
            out[stem] = json.loads(p.read_text())
    return out


def run_fresh(stems, device: str = "cuda") -> Dict[str, dict]:
    """Regenerate artifacts by running the quick benches in-process on
    ``device`` (payloads stay in memory; committed baselines are not
    touched). The benches raise without a card unless ``device="cpu"``."""
    if str(_REPO_ROOT) not in sys.path:
        sys.path.insert(0, str(_REPO_ROOT))
    from benchmarks.torch_run import BENCHES  # noqa: PLC0415

    out = {}
    for stem in stems:
        bench = STEM_TO_BENCH[stem]
        print(f"--- regenerating {stem} (bench:{bench}, quick) ---",
              flush=True)
        res = BENCHES[bench](quick=True, device=device)
        out[stem] = res if isinstance(res, dict) else {"rows": res}
    return out


def _fmt(v: Optional[float]) -> str:
    return "-" if v is None else f"{v:.6g}"


def report(all_deltas: Dict[str, List[Delta]], *, verbose: bool) -> int:
    """Print the per-artifact delta tables; returns the number of
    regressed metrics."""
    n_reg = 0
    for stem, deltas in all_deltas.items():
        flagged = [d for d in deltas
                   if d.status in ("REGRESSED", "improved", "missing")]
        n_reg += sum(d.status == "REGRESSED" for d in deltas)
        print(f"\n== {stem}: {len(deltas)} metrics, "
              f"{sum(d.status == 'REGRESSED' for d in deltas)} regressed, "
              f"{sum(d.status == 'improved' for d in deltas)} improved ==")
        for d in (deltas if verbose else flagged):
            arrow = "v" if d.direction == "lower" else "^"
            print(f"  {d.status:<9} {arrow} {d.metric}: "
                  f"base={_fmt(d.base)} cur={_fmt(d.cur)}"
                  + (f" ratio={d.ratio:.3f}" if d.ratio else ""))
    return n_reg


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="Diff BENCH_torch_*.json perf artifacts against a "
                    "baseline; "
                    "exit nonzero on > tolerance slowdowns.")
    ap.add_argument("--baseline-dir", type=Path, default=_REPO_ROOT,
                    help="directory of baseline BENCH_torch_*.json "
                         "(default: repo root — the committed trajectory)")
    ap.add_argument("--current-dir", type=Path, default=None,
                    help="directory of already-produced current artifacts; "
                         "omitted, the quick benches run fresh in-process")
    ap.add_argument("--only", action="append", default=None,
                    help="artifact stem(s) to check "
                         f"(default: all of {sorted(STEM_TO_BENCH)})")
    ap.add_argument("--tol", type=float, default=0.25,
                    help="relative tolerance band (default 0.25 — quick "
                         "benches on shared CI runners are noisy)")
    ap.add_argument("--min-abs", type=float, default=0.005,
                    help="absolute floor (seconds) a time metric must "
                         "slow down by to regress (default 5ms)")
    ap.add_argument("--smoke", action="store_true",
                    help="validate committed artifacts and self-compare "
                         "(no fresh run); nonzero only on broken artifacts")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where a fresh run runs (default: the card)")
    ap.add_argument("--json", type=Path, default=None,
                    help="also dump the delta report as JSON")
    ap.add_argument("-v", "--verbose", action="store_true",
                    help="print every metric, not only flagged ones")
    args = ap.parse_args(argv)

    stems = args.only or sorted(STEM_TO_BENCH)
    unknown = [s for s in stems if s not in STEM_TO_BENCH]
    if unknown:
        ap.error(f"unknown artifact stem(s) {unknown}; "
                 f"known: {sorted(STEM_TO_BENCH)}")

    baselines = load_artifacts(args.baseline_dir, stems)
    if not baselines:
        print(f"error: no {ARTIFACT_PREFIX}*.json baselines in "
              f"{args.baseline_dir}",
              file=sys.stderr)
        return 2

    if args.smoke:
        current = baselines
    elif args.current_dir is not None:
        current = load_artifacts(args.current_dir, stems)
    else:
        current = run_fresh(list(baselines), device=args.device)

    all_deltas: Dict[str, List[Delta]] = {}
    broken = 0
    for stem, base_payload in baselines.items():
        base = collect_metrics(base_payload)
        if not base:
            print(f"error: {ARTIFACT_PREFIX}{stem}.json has no recognizable "
                  "metrics",
                  file=sys.stderr)
            broken += 1
            continue
        if stem not in current:
            print(f"warning: no current artifact for {stem}; skipping",
                  file=sys.stderr)
            continue
        all_deltas[stem] = compare(
            base, collect_metrics(current[stem]),
            tol=args.tol, min_abs=args.min_abs,
        )

    n_reg = report(all_deltas, verbose=args.verbose or args.smoke)
    if args.json:
        args.json.write_text(json.dumps(
            {stem: [dataclasses.asdict(d) for d in ds]
             for stem, ds in all_deltas.items()}, indent=1))
        print(f"\nwrote {args.json}")

    if args.smoke:
        ok = not broken
        print(f"\nsmoke: {len(all_deltas)} artifacts, "
              f"{sum(len(d) for d in all_deltas.values())} metrics, "
              f"{'OK' if ok else 'BROKEN'}")
        return 0 if ok else 1
    if n_reg:
        print(f"\nFAIL: {n_reg} metric(s) regressed beyond "
              f"tol={args.tol} / min-abs={args.min_abs}s")
        return 1
    print("\nOK: no regressions beyond tolerance")
    return 0


if __name__ == "__main__":
    sys.exit(main())
