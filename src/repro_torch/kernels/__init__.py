"""Pairwise-statistics kernels, their plain versions and the dispatch."""

from .nonlinearity import nonlinear_terms  # noqa: F401
from .ops import (  # noqa: F401
    correlation,
    fused_moment_rows,
    pairwise_moment_sums_chunked,
    pairwise_moment_sums_rows,
    pairwise_moments,
    pairwise_moments_blocked,
    pairwise_moments_chunked,
    standardize,
)
