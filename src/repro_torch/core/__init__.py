"""DirectLiNGAM / VarLiNGAM functional core and facades (local and mesh
plans), and the batched engine (many fits, bootstrap)."""

from .api import (  # noqa: F401
    FitConfig,
    FitResult,
    Partition,
    fit_fn,
    fit_from_stats,
)
from .batched import (  # noqa: F401
    bootstrap_fits,
    bootstrap_fits_with,
    fit_many,
    fit_many_from_stats,
    resample_indices,
)
from .bootstrap import BootstrapResult, bootstrap_lingam  # noqa: F401
from .direct_lingam import DirectLiNGAM, fit_direct_lingam  # noqa: F401
from .ordering import causal_order, ordering_scores  # noqa: F401
from .pruning import estimate_adjacency  # noqa: F401
from .var_lingam import VarLiNGAM, fit_var_lingam  # noqa: F401
