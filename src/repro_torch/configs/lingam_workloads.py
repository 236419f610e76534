"""The paper's own workload configurations (the port's own copy).

Each entry of ``WORKLOADS`` is a (name, m samples, d variables)
causal-discovery cell. ``lingam-1m-100`` is the paper's Fig. 2 size and
the port's main path; ``varlingam-stocks-487`` is the paper's section 4.2
VarLiNGAM panel. ``STREAM_WORKLOADS`` holds the rolling-window settings
of the streaming sessions.
"""

from __future__ import annotations

import dataclasses
from typing import Dict


@dataclasses.dataclass(frozen=True)
class LingamWorkload:
    name: str
    m: int           # samples
    d: int           # variables
    description: str


WORKLOADS: Dict[str, LingamWorkload] = {
    w.name: w
    for w in [
        LingamWorkload(
            "lingam-gene-964", 65_164, 964,
            "Perturb-CITE-seq co-culture dimensions (paper §4.1)",
        ),
        LingamWorkload(
            "lingam-1m-100", 1_000_000, 100,
            "paper Fig. 2 cell: '7 hours on a CPU' at 1M x 100",
        ),
        LingamWorkload(
            "lingam-1m-2048", 1_000_000, 2_048,
            "beyond-paper scale target (hillclimb cell C)",
        ),
        LingamWorkload(
            "varlingam-stocks-487", 4_000, 487,
            "S&P 500 VAR-residual ordering (paper §4.2)",
        ),
    ]
}


@dataclasses.dataclass(frozen=True)
class StreamWorkload:
    name: str
    d: int              # variables
    chunk: int          # rows per posted chunk
    window_chunks: int  # window length in chunks
    lags: int           # VAR order
    refit_every: int    # chunks between refits once the window is full
    description: str


STREAM_WORKLOADS: Dict[str, StreamWorkload] = {
    w.name: w
    for w in [
        StreamWorkload(
            "varlingam-stream-487", 487, 256, 8, 1, 1,
            "rolling VarLiNGAM over 487 stocks: a 2048-row window sliding "
            "by 256 rows, refit every slide (paper §4.2 panel; the --full "
            "setting of benchmarks/bench_stream.py)",
        ),
    ]
}
