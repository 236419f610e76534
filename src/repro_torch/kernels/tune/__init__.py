"""Kernel dispatch and autotuning for the port's moment kernels.

  * :mod:`registry <repro_torch.kernels.tune.registry>` -- the
    :class:`~repro_torch.kernels.tune.registry.KernelVariant` registry of
    the CUDA kernels (B1 pair tile, B2 row tile and slabs, B3 fused) and
    the plain ``blocked`` / ``ref`` backends, and
    :func:`~repro_torch.kernels.tune.registry.dispatch`, the one place a
    launch plan is decided. The only tunable field is B1/B2's pair-block
    edge T, which never changes a pair's sums (the bit-parity contract
    written on the registry).
  * :mod:`autotune <repro_torch.kernels.tune.autotune>` -- the timed
    search: every candidate checked bit for bit against the heuristic
    plan, then timed with CUDA events, the fastest recorded.
  * :mod:`cache <repro_torch.kernels.tune.cache>` -- the persistent
    table: the committed ``default_plans.json`` (measured on the card)
    and a local overlay (``$REPRO_TORCH_TUNE_CACHE``), keyed by the
    card's name, the op and the shape bucket.

Modes (``FitConfig.tune`` / ``dispatch(mode=...)``): ``"off"`` is the
deterministic heuristic (no filesystem), ``"cache"`` (default) reads the
table and never measures, ``"auto"`` runs the timed search once per
bucket and persists the winner.
"""

from . import cache, registry  # noqa: F401
from .cache import (  # noqa: F401
    TuneTable,
    bucket_pow2,
    get_table,
    plan_key,
    reset_table,
    shape_bucket,
)
from .registry import (  # noqa: F401
    ACCUM_CHUNK,
    TILES,
    Constraints,
    KernelVariant,
    Plan,
    device_kind,
    dispatch,
    dispatch_heuristic,
    get_variant,
    register,
)
