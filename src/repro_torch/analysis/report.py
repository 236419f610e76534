"""Roofline attribution report: where a fit's seconds and operations go
(the port of the reference's ``analysis/report.py``).

Splits a DirectLiNGAM fit into its ordering / pruning / solve stages and
reports, per stage and per kernel variant: seconds, operations, bytes,
achieved rate and share of the card's roofline
(:mod:`repro_torch.obs.profile` supplies the timed calls, the analytic
operation counts and the card's peaks: the moment work is held to the
special-function rate, the pruning's matrix work to the fp32 rate). Two
modes::

  PYTHONPATH=src python -m repro_torch.analysis.report --roofline
      # live, on the card: a small profiled fit and its tables

  PYTHONPATH=src python -m repro_torch.analysis.report --roofline --smoke
      # render + validate the committed BENCH_torch_profile.json
      # (no fit); nonzero exit on a missing/broken artifact

``--device cpu --no-cuda`` runs the live report on the CPU with the plain
path only; on the CPU without ``--no-cuda`` the CUDA kernel's row raises.
``--out`` writes the payload (the committed artifact is one such file,
written on the card).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Any, Dict, List, Optional

_REPO_ROOT = Path(__file__).resolve().parents[3]
ARTIFACT = "BENCH_torch_profile.json"

#: Stage rows must carry these keys; ``--smoke`` validates the committed
#: artifact against them (regress tracks best_s and gflops_per_s).
STAGE_KEYS = ("stage", "best_s", "flops", "bytes",
              "gflops_per_s", "roofline_frac", "bound")


def _stage_fns():
    """The fit's three stages as separate functions on the fit's own
    arithmetic."""
    from repro_torch.core import api, pruning

    def ordering_fn(x, config):
        return api._order_for_config(x.float(), config)

    def pruning_fn(x, order, config):
        return pruning.estimate_adjacency(
            x.float(), order, method=config.prune_method,
            threshold=config.prune_threshold, **config.prune_kwargs_dict)

    def solve_fn(x, b):
        x = x.float()
        xc = x - x.mean(dim=0, keepdim=True)
        resid = xc - xc @ b.T
        return (resid * resid).mean(dim=0)

    return ordering_fn, pruning_fn, solve_fn


def _record_row(label: str, rec) -> Dict[str, Any]:
    from repro_torch.obs import profile

    row = {"stage": label, **rec.row(profile.device_peaks())}
    row.pop("op", None)
    row.pop("config", None)
    return row


def _data(m: int, d: int, device):
    """The reference report's upper-triangular SEM with Laplace noise:
    x_j = sum_{k<j} w x_k + e_j."""
    import numpy as np
    import torch

    rng = np.random.default_rng(0)
    w = np.triu(rng.uniform(0.3, 0.8, (d, d)), 1) * \
        (rng.random((d, d)) < 0.4)
    e = rng.laplace(size=(m, d)).astype(np.float32)
    x = np.linalg.solve(np.eye(d) - w.T, e.T).T.astype(np.float32)
    return torch.as_tensor(np.ascontiguousarray(x), device=device)


def live_attribution(
    m: int = 512, d: int = 16, *,
    backend: Optional[str] = None, compaction: str = "staged",
    repeats: int = 2, include_cuda: bool = True, device="cuda",
) -> Dict[str, Any]:
    """Run one profiled fit on ``device``; return {rows, kernels,
    device}.

    The stages re-run the fit's three phases as separate timed calls
    (ordering, adjacency, residual diagnostics), then the whole
    ``fit_fn``, so per-stage seconds are comparable and their sum bounds
    the whole fit's from above. ``repeats`` timed calls per stage; the
    best is reported. ``include_cuda=False`` (the plain path only) needs
    ``device="cpu"``.
    """
    import dataclasses

    from repro_torch.core import api
    from repro_torch.obs import profile

    device = api.resolve_device(device)
    if not include_cuda and device.type != "cpu":
        raise ValueError("include_cuda=False runs the plain path only, on "
                         "device='cpu'")
    profile.enable()
    cfg = api.FitConfig(backend=backend, compaction=compaction)
    x = _data(m, d, device)
    ordering_fn, pruning_fn, solve_fn = _stage_fns()

    for _ in range(repeats):
        order = profile.call(ordering_fn, x, cfg, op="report.ordering",
                             shape=x.shape, config=cfg)
        b = profile.call(pruning_fn, x, order, cfg, op="report.pruning",
                         shape=x.shape, config=cfg)
        profile.call(solve_fn, x, b, op="report.solve", shape=x.shape)
        api.fit_fn(x, cfg)  # timed by profile as op="core.fit"
    stages: List[Dict[str, Any]] = []
    for label, op, key_cfg in (("ordering", "report.ordering", cfg),
                               ("pruning", "report.pruning", cfg),
                               ("solve", "report.solve", None)):
        rec = profile.get(op, x.shape, key_cfg)
        if rec is not None:
            stages.append(_record_row(label, rec))
    full = profile.get("core.fit", x.shape, cfg)
    if full is not None:
        stages.append(_record_row("full_fit", full))

    kernels = kernel_variant_rows(m, d, repeats=repeats,
                                  include_cuda=include_cuda, device=device)
    return {
        "m": m, "d": d,
        "rows": stages,
        "kernels": kernels,
        "device": dataclasses.asdict(profile.device_peaks()),
    }


def kernel_variant_rows(
    m: int, d: int, *, repeats: int = 2, include_cuda: bool = True,
    device="cuda",
) -> List[Dict[str, Any]]:
    """Per-variant utilization of ``pairwise_moments`` at one (m, d): the
    plain ``blocked`` backend and the CUDA kernel (kernel B1), each timed
    through the profiled path on ``device``. The kernel's row raises off
    the card."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.tune import registry
    from repro_torch.obs import profile

    profile.enable()
    rng = np.random.default_rng(1)
    x = torch.as_tensor(rng.normal(size=(m, d)).astype(np.float32),
                        device=device)
    x_std = ops.standardize(x).contiguous()
    c = ops.correlation(x_std).contiguous()

    backends = ["blocked"] + (["cuda"] if include_cuda else [])
    rows: List[Dict[str, Any]] = []
    for backend in backends:
        variant = registry.get_variant("pairwise_moments", backend).name
        # Keyed by the backend as the config: both variants carry the
        # op's one analytic count, so they read one roofline.
        for _ in range(repeats):
            profile.call(ops.pairwise_moments, x_std, c,
                         op="pairwise_moments", shape=(m, d),
                         config=backend, backend=backend)
        row = _record_row(variant, profile.get("pairwise_moments", (m, d),
                                               backend))
        row["variant"] = row.pop("stage")
        row["backend"] = backend
        rows.append(row)
    return rows


def _fmt_table(rows: List[Dict[str, Any]], label_key: str) -> str:
    head = (f"{'stage':<22} {'seconds':>10} {'Gop':>10} {'GB':>10} "
            f"{'Gop/s':>10} {'%roof':>7} {'bound':>8} {'unit':>5}")
    lines = [head, "-" * len(head)]
    for r in rows:
        lines.append(
            f"{str(r.get(label_key, '?')):<22} "
            f"{r.get('best_s', 0.0):>10.4g} "
            f"{r.get('flops', 0.0) / 1e9:>10.4g} "
            f"{r.get('bytes', 0.0) / 1e9:>10.4g} "
            f"{r.get('gflops_per_s', 0.0):>10.3g} "
            f"{100.0 * r.get('roofline_frac', 0.0):>6.2f}% "
            f"{str(r.get('bound', '-')):>8} "
            f"{str(r.get('unit', '-')):>5}"
        )
    return "\n".join(lines)


def render(payload: Dict[str, Any]) -> str:
    dev = payload.get("device", {})
    out = [
        f"roofline attribution — m={payload.get('m')} d={payload.get('d')} "
        f"device={dev.get('name', '?')} "
        f"(peak {dev.get('flops_per_s', 0) / 1e9:.0f} Gop/s special-"
        f"function, {(dev.get('fp32_flops_per_s') or dev.get('flops_per_s', 0)) / 1e9:.0f} GFLOP/s "
        f"fp32, {dev.get('hbm_bw', 0) / 1e9:.0f} GB/s)",
        "",
        "per-stage attribution:",
        _fmt_table(payload.get("rows", []), "stage"),
        "",
        "per-kernel-variant utilization (pairwise_moments):",
        _fmt_table(payload.get("kernels", []), "variant"),
    ]
    return "\n".join(out)


def smoke(repo_root: Path = _REPO_ROOT) -> int:
    """Validate + render the committed BENCH_torch_profile.json."""
    p = repo_root / ARTIFACT
    if not p.exists():
        print(f"error: {p} missing", file=sys.stderr)
        return 1
    try:
        payload = json.loads(p.read_text())
    except ValueError as e:
        print(f"error: {p} unparsable: {e}", file=sys.stderr)
        return 1
    rows = payload.get("rows", [])
    kernels = payload.get("kernels", [])
    broken = 0
    for row in rows:
        missing = [k for k in STAGE_KEYS if k not in row]
        if missing:
            print(f"error: stage row {row.get('stage', '?')!r} missing "
                  f"{missing}", file=sys.stderr)
            broken += 1
    if not rows:
        print(f"error: {ARTIFACT} has no stage rows", file=sys.stderr)
        broken += 1
    if not kernels:
        print(f"error: {ARTIFACT} has no kernel rows", file=sys.stderr)
        broken += 1
    print(render(payload))
    print(f"\nsmoke: {len(rows)} stage rows, {len(kernels)} kernel rows, "
          f"{'OK' if not broken else 'BROKEN'}")
    return 1 if broken else 0


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="Per-stage / per-kernel roofline attribution report.")
    ap.add_argument("--roofline", action="store_true",
                    help="produce the attribution report (the only mode)")
    ap.add_argument("--smoke", action="store_true",
                    help=f"validate + render the committed {ARTIFACT} "
                         "instead of running a live fit")
    ap.add_argument("--m", type=int, default=512)
    ap.add_argument("--d", type=int, default=16)
    ap.add_argument("--backend", type=str, default=None,
                    help="force the fit backend (default: the kernel)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the live fit runs (default: the card)")
    ap.add_argument("--no-cuda", action="store_true",
                    help="the plain path only (needs --device cpu)")
    ap.add_argument("--out", type=str, default=None,
                    help="also write the payload as JSON")
    args = ap.parse_args(argv)

    if not args.roofline:
        ap.error("nothing to do: pass --roofline")
    if args.smoke:
        return smoke()
    if args.no_cuda and args.device != "cpu":
        ap.error("--no-cuda keeps the plain path only: pass --device cpu")

    payload = live_attribution(
        args.m, args.d, backend=args.backend,
        include_cuda=not args.no_cuda, device=args.device,
    )
    print(render(payload))
    if args.out:
        from repro_torch.obs import provenance

        payload["provenance"] = provenance(str(_REPO_ROOT))
        Path(args.out).write_text(json.dumps(payload, indent=1))
        print(f"\nwrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
