"""Pairwise-statistics kernel, its plain versions and the dispatch."""

from .nonlinearity import nonlinear_terms  # noqa: F401
from .ops import (  # noqa: F401
    correlation,
    pairwise_moments,
    pairwise_moments_blocked,
    standardize,
)
