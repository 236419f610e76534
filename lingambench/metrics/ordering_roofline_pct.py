"""`ordering_roofline_pct.<cell>`: the least time of the orderings the
traced operations needed (``lib/roofline.py``) over the device time of
every kernel launched inside the port's ``fit.ordering`` spans."""

from lingambench.lib import readers

RANGES = ("fit.ordering",)


def read(ctx, metric):
    return readers.range_roofline_pct(ctx, RANGES[0])
