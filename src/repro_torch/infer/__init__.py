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

Root-cause attribution and the query engine (the reference's
``infer/rca.py`` and ``infer/query.py``) need the kernel tuner and
telemetry and are not ported yet.
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
