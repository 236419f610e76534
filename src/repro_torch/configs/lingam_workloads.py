"""The paper's own workload configurations (the port's own copy).

Each entry is a (name, m samples, d variables) causal-discovery cell.
``lingam-1m-100`` is the paper's Fig. 2 size and the port's main path.
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
