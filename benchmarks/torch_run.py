"""Benchmark runner for the PyTorch/CUDA port: the paper's experiments and
the engine's benches.

    PYTHONPATH=src python3 -m benchmarks.torch_run [--only NAME] [--full]
        [--device cuda|cpu] [--profile] [--out-dir DIR]

NAME is one of the reference runner's twelve (``benchmarks/run.py``):
speedup (paper Fig. 2), equivalence (Fig. 3), notears (section 3.1),
gene (Table 1), stocks (Fig. 4 / Table 2), and the engine's bootstrap,
sharded, stream, tune, infer, drift and profile. Each run writes
``BENCH_torch_<stem>.json`` (``tune`` writes ``BENCH_torch_kernels.json``)
at the repo root, or in ``--out-dir``, with the hardware it ran on
(``hardware``: for the card, its name and power limit as ``nvidia-smi``
reports them) and the run's provenance. Without ``--only`` every bench
runs. The benches run on the card unless ``--device cpu`` is given, and
raise without one. ``--profile`` turns ``repro_torch.obs.profile`` on
around each bench and joins its cost records onto the artifact's rows.

A bench that raises writes no artifact: the runner prints its traceback,
goes on to the next bench and exits nonzero.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

_REPO_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.join(_REPO_ROOT, "src"))

from benchmarks import (  # noqa: E402
    torch_bootstrap,
    torch_drift,
    torch_equivalence,
    torch_gene,
    torch_infer,
    torch_notears,
    torch_profile,
    torch_sharded,
    torch_speedup,
    torch_stocks,
    torch_stream,
    torch_tune,
)

BENCHES = {
    "speedup": torch_speedup.run,          # paper Fig. 2
    "equivalence": torch_equivalence.run,  # paper Fig. 3
    "notears": torch_notears.run,          # paper section 3.1
    "gene": torch_gene.run,                # paper Table 1
    "stocks": torch_stocks.run,            # paper Fig. 4 / Table 2
    "bootstrap": torch_bootstrap.run,      # loop against the batched engine
    "sharded": torch_sharded.run,          # mesh plan against the local oracle
    "stream": torch_stream.run,            # rolling window against scratch
    "tune": torch_tune.run,                # heuristic against tuned plans
    "infer": torch_infer.run,              # batched queries against a loop
    "drift": torch_drift.run,              # drift detection, refit savings
    "profile": torch_profile.run,          # cost accounting, roofline rows
}

# Bench name -> artifact stem (BENCH_torch_<stem>.json).
ARTIFACTS = {name: name for name in BENCHES}
ARTIFACTS["tune"] = "kernels"

# Cost-record fields joined onto a payload's matching rows.
_STAMP_KEYS = ("flops", "bytes", "temp_bytes", "gflops_per_s",
               "gbytes_per_s", "roofline_frac", "bound")


def device_info(device: str) -> dict:
    """The hardware a run measured on: for the card, its name, count and
    ``nvidia-smi``'s name and power limit."""
    import torch

    if device == "cpu":
        return {"platform": "cpu"}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "nvidia_smi": smi}


def _default(o):
    import numpy as np

    if isinstance(o, np.integer):
        return int(o)
    if isinstance(o, np.floating):
        return float(o)
    if isinstance(o, np.bool_):
        return bool(o)
    raise TypeError(type(o))


def stamp_rows(payload: dict, snap: dict) -> dict:
    """Join captured cost records onto a payload's row dicts.

    A row matches a record on its ``op`` field (and, when both carry
    one, its ``shape``); a matched row gains the record's operations,
    bytes and utilization fields. The whole record table also lands
    under ``payload["profile"]``, so unjoined costs are kept."""
    by_op = {}
    for rec in snap.get("records", []):
        by_op.setdefault(rec["op"], []).append(rec)

    def stamp(node):
        if isinstance(node, list):
            for item in node:
                stamp(item)
        elif isinstance(node, dict):
            hit = next((rec for rec in by_op.get(node.get("op"), [])
                        if "shape" not in node
                        or list(node["shape"]) == list(rec["shape"])), None)
            if hit is not None:
                for k in _STAMP_KEYS:
                    if k in hit and k not in node:
                        node[k] = hit[k]
            for v in node.values():
                stamp(v)

    stamp(payload.get("rows"))
    payload["profile"] = snap
    return payload


def run_benches(names, *, quick: bool, device: str, profile: bool,
                out_dir: str) -> int:
    """Run ``names`` in turn, writing one artifact for each bench that
    finished. Returns the number of benches that raised."""
    from repro_torch import obs
    from repro_torch.obs import profile as obs_profile

    hardware = device_info(device)
    print(f"hardware: {hardware}")
    prov = obs.provenance(_REPO_ROOT)
    failed = []
    for name in names:
        t0 = time.perf_counter()
        print(f"=== torch bench:{name} ===", flush=True)
        obs_profile.reset()
        if profile:
            obs_profile.enable()
        try:
            res = BENCHES[name](quick=quick, device=device)
        except Exception:  # noqa: BLE001 -- reported, exit code nonzero
            traceback.print_exc()
            failed.append(name)
            print(f"=== torch bench:{name} FAILED: no artifact ===\n",
                  flush=True)
            continue
        finally:
            if profile:
                obs_profile.disable()
        seconds = time.perf_counter() - t0
        print(f"=== torch bench:{name} done in {seconds:.1f}s ===\n")
        payload = res if isinstance(res, dict) else {"rows": res}
        if profile:
            payload = stamp_rows(dict(payload), obs_profile.snapshot())
        out = os.path.join(out_dir, f"BENCH_torch_{ARTIFACTS[name]}.json")
        with open(out, "w") as f:
            json.dump({"bench": ARTIFACTS[name], "quick": quick,
                       "timestamp": time.strftime("%Y-%m-%dT%H:%M:%S"),
                       "hardware": hardware, "provenance": prov,
                       "seconds": seconds, **payload},
                      f, indent=1, default=_default)
        print(f"wrote {out}")
    if failed:
        print(f"torch_run: {len(failed)} bench(es) failed: {failed}",
              file=sys.stderr)
    return len(failed)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true",
                    help="the paper's sizes")
    ap.add_argument("--only", choices=sorted(BENCHES), default=None)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--profile", action="store_true",
                    help="turn repro_torch.obs.profile on around each bench "
                         "and join its cost records onto the artifact's rows")
    ap.add_argument("--out-dir", default=_REPO_ROOT,
                    help="where the artifacts go (default: the repo root)")
    args = ap.parse_args(argv)
    names = [args.only] if args.only else list(BENCHES)
    os.makedirs(args.out_dir, exist_ok=True)
    failed = run_benches(names, quick=not args.full, device=args.device,
                         profile=args.profile, out_dir=args.out_dir)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
