"""The readers of the port's inner spans on a synthetic event list: the
moment kernels' roofline share (``kernels.moments``) and the ordering
step's own passes (``fit.ordering`` less ``kernels.moments``), and what
each reads where the port has no such span."""

import types

import pytest

from lingambench.lib import roofline, tracing
from lingambench.lib.tracing import Event
from lingambench.metrics import moment_kernel_roofline_pct as mk
from lingambench.metrics import ordering_passes_device_ms as op

SHAPES = [(1_000_000, 100, 1)]
PEAKS = types.SimpleNamespace(sfu_per_s=roofline.sfu_rate(132, 1.98e9),
                              bytes_per_s=3.35e12)


def _trace(with_moments=True):
    """Two operations. In each, a fit.ordering range holds one step's
    phases: a standardize pass, a kernels.moments range with the two
    moment kernels, a scores pass and a residualize pass; a pruning
    kernel follows outside the ordering."""
    ev = []
    corr = 0

    def kernel(name, t_launch, t0, t1):
        nonlocal corr
        corr += 1
        ev.append(Event("launch", "cudaLaunchKernel", t_launch,
                        t_launch + 0.01, corr=corr))
        ev.append(Event("device", name, t0, t1, corr=corr,
                        device_kind="kernel"))

    for base in (0.0, 10.0):
        ev.append(Event("range", "lingambench.op", base, base + 10.0))
        ev.append(Event("range", "fit.ordering", base + 1.0, base + 8.0))
        ev.append(Event("range", "order.standardize", base + 1.0,
                        base + 2.0))
        if with_moments:
            ev.append(Event("range", "kernels.moments", base + 2.0,
                            base + 4.0))
        ev.append(Event("range", "order.scores", base + 4.0, base + 5.0))
        ev.append(Event("range", "order.residualize", base + 5.0,
                        base + 6.0))
        kernel("reduce_f64", base + 1.5, base + 1.6, base + 1.9)      # 0.3
        kernel("pair_partials_kernel<4>", base + 2.5, base + 2.6,
               base + 4.6)                                            # 2.0
        kernel("pairwise_moment_reduce", base + 3.0, base + 4.6,
               base + 4.8)                                            # 0.2
        kernel("entropy", base + 4.5, base + 4.8, base + 5.2)         # 0.4
        kernel("residual", base + 5.5, base + 5.6, base + 5.7)        # 0.1
        kernel("lu", base + 8.5, base + 8.6, base + 9.1)              # 0.5
    return ev


def _ctx(events, names):
    s = tracing.summarize(events, names)
    return types.SimpleNamespace(trace=s, peaks=PEAKS, n_ops=s.n_ops,
                                 items=s.n_ops, window_s=s.window_s,
                                 shapes=SHAPES)


def _names():
    return sorted({"lingambench.op", *mk.RANGES, *op.RANGES})


def test_moment_kernel_roofline_reads_the_kernels_in_their_span():
    ctx = _ctx(_trace(), _names())
    assert ctx.trace.device_s_in("kernels.moments") == pytest.approx(
        2 * (2.0 + 0.2))
    least = 2 * roofline.ordering_least_seconds(SHAPES, PEAKS.sfu_per_s,
                                                PEAKS.bytes_per_s)
    assert mk.read(ctx, None) == pytest.approx(100 * least / 4.4)


def test_ordering_passes_are_the_ordering_less_the_moment_kernels():
    ctx = _ctx(_trace(), _names())
    # per operation: ordering 0.3 + 2.0 + 0.2 + 0.4 + 0.1 = 3.0 s,
    # of which the moment kernels 2.2 s
    assert op.read(ctx, None) == pytest.approx(1e3 * 0.8)
    by = ctx.trace.device_s_by_range
    assert by["order.standardize"] == pytest.approx(2 * 0.3)
    assert by["order.scores"] == pytest.approx(2 * 0.4)
    assert by["order.residualize"] == pytest.approx(2 * 0.1)
    assert "order.compact" not in by        # no such range: not listed


@pytest.mark.parametrize("reader", [mk, op])
def test_without_the_moment_span_the_readers_read_nothing(reader):
    ctx = _ctx(_trace(with_moments=False), _names())
    assert ctx.trace.device_s_in("kernels.moments") is None
    assert ctx.trace.device_s_in("fit.ordering") == pytest.approx(6.0)
    assert reader.read(ctx, None) is None


@pytest.mark.parametrize("reader", [mk, op])
def test_no_trace_reads_nothing(reader):
    ctx = types.SimpleNamespace(trace=None, peaks=PEAKS, n_ops=0, items=0,
                                window_s=1.0, shapes=SHAPES)
    assert reader.read(ctx, None) is None


def test_the_phase_ranges_are_asked_for():
    """The harness attributes device time to the ranges the cell's readers
    list; the passes reader lists every phase of the step."""
    assert mk.RANGES == ("kernels.moments",)
    assert set(op.RANGES) == {"fit.ordering", "kernels.moments",
                              "order.standardize", "order.scores",
                              "order.residualize", "order.compact"}
