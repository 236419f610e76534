"""`ordering_passes_device_ms.<cell>`: device milliseconds per operation
of the kernels launched inside the port's ``fit.ordering`` spans but not
inside its ``kernels.moments`` spans: the ordering step's own passes
(standardization, scores, residualization, the staged gathers), without
kernels B1/B2. The phases' ranges are listed too, so a traced run's
"device seconds by range" splits the total by phase. A port without the
``kernels.moments`` span reads nothing."""

from lingambench.lib import readers

RANGES = ("fit.ordering", "kernels.moments", "order.standardize",
          "order.scores", "order.residualize", "order.compact")


def read(ctx, metric):
    t = ctx.trace
    if t is None:
        return None
    ordering, moments = t.device_s_in(RANGES[0]), t.device_s_in(RANGES[1])
    if not ordering or moments is None:
        return None
    return 1e3 * (ordering - moments) / t.n_ops
