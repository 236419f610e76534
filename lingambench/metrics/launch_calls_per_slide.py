"""`launch_calls_per_slide.<cell>`: CUDA kernel and graph launch API calls (runtime or
driver) per traced operation, counted from the profiler's trace."""

from lingambench.lib import readers


def read(ctx, metric):
    return readers.launch_calls_per_op(ctx)
