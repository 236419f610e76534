"""`pruning_device_ms.<cell>`: device milliseconds per operation of the
kernels launched inside the port's ``fit.pruning`` spans."""

from lingambench.lib import readers

RANGES = ("fit.pruning",)


def read(ctx, metric):
    return readers.range_device_ms_per_op(ctx, RANGES[0])
