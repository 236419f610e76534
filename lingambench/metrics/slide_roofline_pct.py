"""`slide_roofline_pct.<cell>`: the least time of a slide's refits'
orderings over the device time of every kernel launched inside
``flush_streams()`` (the engine's ``serve.flush`` span, which also covers
the flush the last post of a slide triggers). The refit from moments has
no ordering span, so the pruning and the VAR solve are in the time."""

from lingambench.lib import readers

RANGES = ("serve.flush",)


def read(ctx, metric):
    return readers.range_roofline_pct(ctx, RANGES[0])
