"""Gene-regulatory discovery with interventions (paper section 4.1,
Table 1), on the PyTorch/CUDA port.

    PYTHONPATH=src python3 examples/torch_gene_discovery.py [--full]
        [--device cpu]

Synthetic Perturb-seq-like data (the real Perturb-CITE-seq is not
available offline): single-gene interventions, 80/20 train/held-out
split, DirectLiNGAM and NOTEARS on the card, Stein-VI scoring of
interventional NLL / MAE. ``--full`` is the paper's gene width (d = 961).
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from benchmarks.torch_gene import run  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true",
                    help="paper-scale d=961")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args()
    results = run(quick=not args.full, device=args.device)
    print("\nSummary (lower is better):")
    for method in ("directlingam", "notears"):
        r = results[method]
        print(f"  {method:14s} I-NLL={r['inll']:.3f}  I-MAE={r['imae']:.3f}"
              f"  fit {r['fit_s']:.2f} s")


if __name__ == "__main__":
    main()
