"""`monitor_device_ms.<cell>`: device milliseconds per operation of the
kernels and copies launched inside the port's ``stream.monitor`` spans:
each scored chunk's drift statistics and their copy to the host. A port
without that span reads nothing."""

from lingambench.lib import readers

RANGES = ("stream.monitor",)


def read(ctx, metric):
    return readers.range_device_ms_per_op(ctx, RANGES[0])
