"""Roofline-term derivation over the port's device peaks.

Per (kernel x shape x mesh) cell:

    compute term    = operations_per_device       / peak operation rate
    memory term     = bytes_per_device            / hbm_bw
    collective term = collective_bytes_per_device / ici_bw

The peaks come from :func:`repro_torch.obs.profile.device_peaks` (the
card's SM count and clock on a card; ``REPRO_TORCH_PEAKS`` overrides).
Operations and bytes come from the analytic model
(:func:`repro_torch.obs.profile.analytic_cost`: special-function
operations for the moment kernels), collective bytes from the mesh
plan's own collective helper (:func:`repro_torch.obs.profile.
collective_bytes`).

``python -m repro_torch.analysis.report --roofline`` renders the
per-stage attribution table built on these terms.
"""

from __future__ import annotations

from typing import Dict, Optional

from repro_torch.obs.profile import (  # noqa: F401  (re-exported surface)
    DevicePeaks,
    analytic_cost,
    collective_bytes,
    device_peaks,
    utilization,
)


def roofline_terms(
    flops_per_dev: float,
    bytes_per_dev: float,
    coll_bytes_per_dev: float = 0.0,
    peaks: Optional[DevicePeaks] = None,
    unit: str = "sfu",
) -> Dict[str, object]:
    """Per-device seconds for each roofline term and the binding one;
    ``unit`` names the kind of the operations ("sfu" or "fp32")."""
    peaks = peaks or device_peaks()
    t_c = flops_per_dev / peaks.rate(unit)
    t_m = bytes_per_dev / peaks.hbm_bw
    t_n = coll_bytes_per_dev / peaks.ici_bw
    dominant = max(
        [("compute", t_c), ("memory", t_m), ("collective", t_n)],
        key=lambda kv: kv[1],
    )[0]
    return {
        "compute_s": t_c,
        "memory_s": t_m,
        "collective_s": t_n,
        "dominant": dominant,
        "bound_s": max(t_c, t_m, t_n),
        "peaks": peaks.name,
    }
