"""`moment_kernel_roofline_pct.<cell>`: the least time of the orderings
the traced operations needed (``lib/roofline.py``) over the device time
of every kernel launched inside the port's ``kernels.moments`` spans: the
launches of kernel B1 (``pairwise_moments``) and B2
(``pairwise_moment_sums_rows``, ``pairwise_moment_sums_slabs``), the
partial sums and their reduction. A port without that span reads
nothing."""

from lingambench.lib import readers

RANGES = ("kernels.moments",)


def read(ctx, metric):
    return readers.range_roofline_pct(ctx, RANGES[0])
