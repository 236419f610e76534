"""`setup_s`: process start to the first timed operation (host clock):
imports, kernel loads (and builds, on a checkout's first run), data,
the warm-up of the cell's own shapes."""


def read(ctx, metric):
    return ctx.setup_s
