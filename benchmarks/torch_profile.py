"""Cost-accounting rows on the port: stage attribution and kernel
utilization -> BENCH_torch_profile.json.

    PYTHONPATH=src python3 -m benchmarks.torch_run --only profile [--full]

The reference bench (``benchmarks/bench_profile.py``): a thin call of
the roofline attribution (:func:`repro_torch.analysis.report.
live_attribution`) at (512, 16), or (2048, 64) with ``--full``. Its
stage rows (ordering, pruning, solve, full_fit: seconds, operations,
bytes, rate, share of the card's roofline) come from a fit with the
CUDA kernel (backend ``None``), and its kernel rows time
``pairwise_moments`` on the plain ``blocked`` backend and on kernel B1.
On the CPU only the plain rows run (``include_cuda=False``). The
payload keeps the keys ``report --roofline --out`` writes (``m``, ``d``,
``rows``, ``kernels``, ``device``; the runner adds ``provenance``), so
``python -m repro_torch.analysis.report --roofline --smoke`` reads it.
"""

from __future__ import annotations

from repro_torch.analysis import report
from repro_torch.core import api
from repro_torch.obs import profile

from benchmarks.torch_common import launch_counts, launches_since


def run(quick: bool = True, device="cuda"):
    device = api.resolve_device(device)
    profile.reset()
    m, d = (512, 16) if quick else (2048, 64)
    before = launch_counts()
    was_on = profile.enabled()
    try:  # live_attribution turns the profiler on
        payload = report.live_attribution(
            m, d, repeats=2, include_cuda=device.type == "cuda",
            device=device)
    finally:
        profile.enable(was_on)
    payload["launches"] = launches_since(before)
    for row in payload["rows"]:
        print(f"torch_profile,stage={row['stage']},"
              f"best_s={row['best_s']:.6f},"
              f"gflops_per_s={row['gflops_per_s']:.4f},"
              f"roofline_frac={row['roofline_frac']:.4f}")
    for row in payload["kernels"]:
        print(f"torch_profile,variant={row['variant']},"
              f"best_s={row['best_s']:.6f},"
              f"gflops_per_s={row['gflops_per_s']:.4f},"
              f"roofline_frac={row['roofline_frac']:.4f}")
    return payload
