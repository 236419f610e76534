"""`fit_s`: seconds per operation, the window over the operations it
completed (host clock)."""

from lingambench.lib import readers


def read(ctx, metric):
    return readers.seconds_per_op(ctx)
