"""Streaming causal discovery: incremental moments, rolling windows,
sessions.

  * :mod:`repro_torch.stream.stats` -- mergeable sufficient statistics
    (:class:`MomentState`: Chan-style merge + exact retraction).
  * :mod:`repro_torch.stream.window` -- :class:`ChunkRing` +
    :class:`RollingVarLiNGAM`: a VarLiNGAM whose window advances by
    absorbing/retracting chunks instead of rescanning.
  * :mod:`repro_torch.stream.session` -- :class:`StreamSession` /
    :class:`GraphDelta`: one client's rolling state and graph deltas.
  * :mod:`repro_torch.stream.monitor` -- :class:`GraphHealthMonitor`:
    CUSUM drift detection on the served graph's structural noise, from
    each chunk's moment summary.
"""

from .monitor import (  # noqa: F401
    DriftAlert,
    GraphHealthMonitor,
    MonitorConfig,
    score_chunks_many,
)
from .session import (  # noqa: F401
    GraphDelta,
    StreamConfig,
    StreamSession,
    bucket_key,
    graph_delta,
)
from .stats import MomentState  # noqa: F401
from .stats import (  # noqa: F401
    from_chunk,
    init,
    merge,
    retract,
    retract_chunk,
    update_chunk,
)
from .window import (  # noqa: F401
    ChunkRing,
    RollingFit,
    RollingVarLiNGAM,
    direct_window_fit,
    lagged_rows,
)
