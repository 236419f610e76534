"""Causal query and effect inference over fitted graphs.

Every entry point takes the functional core's
:class:`~repro_torch.core.api.FitResult` (or a stream's moment store)
and runs on the fit's device:

  * :mod:`repro_torch.infer.effects` -- total-effect matrices
    ``(I - B)^-1`` by triangular solve in causal order (never a dense
    inverse), path-specific effects, lag-propagated VAR impulse
    responses, and bootstrap effect confidence intervals.
  * :mod:`repro_torch.infer.intervene` -- do-operator graph surgery and
    interventional means/covariances from observational moments
    (the moment store's included: no row re-reads).
  * :mod:`repro_torch.infer.rca` -- root-cause attribution of anomalous
    samples by noise-term decomposition ``e = (I - B) x``.
  * :mod:`repro_torch.infer.query` --
    :class:`~repro_torch.infer.query.QueryEngine`: admits effect,
    intervention and RCA requests against fitted or streaming graphs and
    answers each (kind, shape) group as one batched computation
    (:meth:`repro_torch.serve.engine.CausalDiscoveryEngine.query` is the
    serving-side entry).
"""

from .effects import (  # noqa: F401
    EffectCI,
    bootstrap_effects,
    effects_avoiding,
    effects_through,
    target_effects_row,
    total_effects,
    total_effects_impl,
    var_irf,
)
from .intervene import (  # noqa: F401
    do_arrays,
    interventional_from_state,
    interventional_moments,
    mutilate,
    noise_stats,
)
from .query import (  # noqa: F401
    EffectQuery,
    FittedGraph,
    InterventionQuery,
    QueryEngine,
    RCAQuery,
)
from .rca import (  # noqa: F401
    RCAResult,
    attribute,
    drift_root_candidates,
    noise_scores_impl,
    noise_terms_impl,
)
