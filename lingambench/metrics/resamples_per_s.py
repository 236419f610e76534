"""`resamples_per_s`: bootstrap resamples completed over the window's
seconds (host clock)."""

from lingambench.lib import readers


def read(ctx, metric):
    return readers.items_per_s(ctx)
