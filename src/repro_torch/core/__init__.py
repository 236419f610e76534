"""DirectLiNGAM functional core and facade (local plan)."""

from .api import FitConfig, FitResult, fit_fn, fit_from_stats  # noqa: F401
from .direct_lingam import DirectLiNGAM  # noqa: F401
from .ordering import causal_order, causal_order_compact  # noqa: F401
from .pruning import estimate_adjacency  # noqa: F401
