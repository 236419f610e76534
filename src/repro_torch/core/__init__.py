"""DirectLiNGAM / VarLiNGAM functional core and facades (local plan)."""

from .api import FitConfig, FitResult, fit_fn, fit_from_stats  # noqa: F401
from .direct_lingam import DirectLiNGAM  # noqa: F401
from .ordering import causal_order, causal_order_compact  # noqa: F401
from .pruning import estimate_adjacency  # noqa: F401
from .var_lingam import VarLiNGAM, fit_var_lingam  # noqa: F401
