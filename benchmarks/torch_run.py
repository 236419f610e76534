"""Benchmark runner for the PyTorch/CUDA port: the paper's experiments.

    PYTHONPATH=src python3 -m benchmarks.torch_run --only NAME [--full]
        [--device cuda|cpu]

NAME is one of speedup (paper Fig. 2), equivalence (Fig. 3), notears
(section 3.1), gene (Table 1) and stocks (Fig. 4 / Table 2). Each run
writes ``BENCH_torch_<name>.json`` at the repo root with the hardware it
ran on (``hardware``: for the card, its name and power limit as
``nvidia-smi`` reports them). Without ``--only`` every benchmark runs.
The benches run on the card unless ``--device cpu`` is given, and raise
without one.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

_REPO_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.join(_REPO_ROOT, "src"))

from benchmarks import (  # noqa: E402
    torch_equivalence,
    torch_gene,
    torch_notears,
    torch_speedup,
    torch_stocks,
)

BENCHES = {
    "speedup": torch_speedup.run,          # paper Fig. 2
    "equivalence": torch_equivalence.run,  # paper Fig. 3
    "notears": torch_notears.run,          # paper section 3.1
    "gene": torch_gene.run,                # paper Table 1
    "stocks": torch_stocks.run,            # paper Fig. 4 / Table 2
}


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
    raise TypeError(type(o))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true",
                    help="the paper's sizes")
    ap.add_argument("--only", choices=sorted(BENCHES), default=None)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args()
    hardware = device_info(args.device)
    print(f"hardware: {hardware}")
    for name, fn in BENCHES.items():
        if args.only and name != args.only:
            continue
        t0 = time.perf_counter()
        print(f"=== torch bench:{name} ===", flush=True)
        res = fn(quick=not args.full, device=args.device)
        seconds = time.perf_counter() - t0
        print(f"=== torch bench:{name} done in {seconds:.1f}s ===\n")
        out = os.path.join(_REPO_ROOT, f"BENCH_torch_{name}.json")
        with open(out, "w") as f:
            json.dump({"bench": name, "quick": not args.full,
                       "timestamp": time.strftime("%Y-%m-%dT%H:%M:%S"),
                       "hardware": hardware, "seconds": seconds, **res},
                      f, indent=1, default=_default)
        print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
