"""The traced run's arithmetic on a synthetic event list: the idle
union, the attribution of kernels to the host ranges their launches were
made in, the launch count, and the readers built on them."""

import types

import pytest

from lingambench.lib import readers, roofline, tracing
from lingambench.lib.tracing import Event


def _trace():
    """Two operations; a fit.ordering range in each; kernels launched
    inside and outside them, one linked only through its host operator."""
    ev = [
        Event("range", "lingambench.op", 0.0, 10.0),
        Event("range", "fit.ordering", 1.0, 6.0),
        Event("range", "fit.pruning", 6.0, 9.0),
        Event("range", "lingambench.op", 10.0, 20.0),
        Event("range", "fit.ordering", 11.0, 15.0),
        # launches (CUPTI correlation 1..5)
        Event("launch", "cudaLaunchKernel", 1.5, 1.6, corr=1),
        Event("launch", "cuLaunchKernel", 2.0, 2.1, corr=2),
        Event("launch", "cudaLaunchKernel", 7.0, 7.1, corr=3),
        Event("launch", "cudaMemcpyAsync", 8.0, 8.1, corr=4),
        Event("launch", "cudaGraphLaunch", 12.0, 12.1, corr=5),
        Event("launch", "cudaStreamSynchronize", 16.0, 17.0, corr=9),
        # a host operator that launched kernel 6 (no runtime event seen)
        Event("op", "aten::mm", 13.0, 13.5, corr=77),
        Event("op", "aten::item", 16.0, 17.0, corr=78),
        # the device
        Event("device", "pairwise_moment_partials", 2.0, 4.0, corr=1,
              device_kind="kernel"),
        Event("device", "reduce", 4.0, 5.0, corr=2, device_kind="kernel"),
        Event("device", "solve", 7.5, 8.0, corr=3, device_kind="kernel"),
        Event("device", "Memcpy DtoH", 8.2, 8.4, corr=4,
              device_kind="gpu_memcpy"),
        Event("device", "graph_kernel", 12.5, 14.0, corr=5,
              device_kind="kernel"),
        Event("device", "gemm", 14.0, 14.5, corr=6, linked=77,
              device_kind="kernel"),
        # outside the window: not counted
        Event("device", "late", 21.0, 22.0, corr=8, device_kind="kernel"),
    ]
    return ev


def test_union_and_gaps():
    iv = [(1.0, 3.0), (2.0, 4.0), (6.0, 7.0), (9.0, 12.0)]
    assert tracing.union_seconds(iv, 0.0, 10.0) == pytest.approx(5.0)
    assert tracing.idle_gaps(iv, 0.0, 10.0) == [(0.0, 1.0), (4.0, 6.0),
                                               (7.0, 9.0)]
    assert tracing.union_seconds([], 0.0, 1.0) == 0.0


def test_summary_attributes_kernels_by_their_launch():
    s = tracing.summarize(_trace(), ["fit.ordering", "fit.pruning",
                                     "serve.flush"])
    assert s.window_s == pytest.approx(20.0)
    assert s.n_ops == 2
    # device busy: [2,5] + [7.5,8] + [8.2,8.4] + [12.5,14.5]
    assert s.busy_s == pytest.approx(3.0 + 0.5 + 0.2 + 2.0)
    assert s.device_s_in("fit.ordering") == pytest.approx(2.0 + 1.0 + 1.5
                                                          + 0.5)
    assert s.device_s_in("fit.pruning") == pytest.approx(0.5)
    assert s.device_s_in("serve.flush") is None   # no such range
    assert s.launch_calls == 4                    # not the copy or the sync
    assert (s.kernels, s.kernels_with_launch) == (5, 4)


def test_breakdown_names_the_device_ops_and_what_the_host_did():
    b = tracing.summarize(_trace(), []).breakdown
    assert b["device_ops"][0] == ["pairwise_moment_partials", 2.0]
    # gaps [0, 2] [5, 7.5] [8, 8.2] [8.4, 12.5] [14.5, 20], each labelled
    # by the innermost range open at its middle
    labels = {k: v for k, v in b["idle_gaps"]}
    assert labels == pytest.approx({"fit.ordering": 2.0, "fit.pruning": 2.7,
                                    "lingambench.op": 9.6})
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10


def test_no_trace_or_no_device_reads_nothing():
    assert tracing.summarize([], []) is None
    ops_only = [Event("range", "lingambench.op", 0.0, 1.0)]
    assert tracing.summarize(ops_only, []) is None
    ctx = types.SimpleNamespace(trace=None, peaks=None, n_ops=0, items=0,
                                window_s=1.0, shapes=[(10, 3, 1)])
    for fn in (readers.idle_pct, readers.launch_calls_per_op,
               readers.seconds_per_op, readers.items_per_s):
        assert fn(ctx) is None
    assert readers.range_roofline_pct(ctx, "fit.ordering") is None


def test_readers_on_the_synthetic_trace():
    s = tracing.summarize(_trace(), ["fit.ordering", "fit.pruning"])
    peaks = types.SimpleNamespace(sfu_per_s=roofline.sfu_rate(132, 1.98e9),
                                  bytes_per_s=3.35e12)
    ctx = types.SimpleNamespace(trace=s, peaks=peaks, n_ops=2, items=2,
                                window_s=20.0, shapes=[(1_000_000, 100, 1)])
    assert readers.idle_pct(ctx) == pytest.approx(100 * (1 - 5.7 / 20.0))
    least = 2 * roofline.ordering_least_seconds([(1_000_000, 100, 1)],
                                                peaks.sfu_per_s,
                                                peaks.bytes_per_s)
    assert readers.range_roofline_pct(ctx, "fit.ordering") == pytest.approx(
        100 * least / 5.0)
    assert readers.range_device_ms_per_op(ctx, "fit.pruning") == \
        pytest.approx(250.0)
    assert readers.launch_calls_per_op(ctx) == 2.0
    ctx.peaks = types.SimpleNamespace(sfu_per_s=None, bytes_per_s=3.35e12)
    assert readers.range_roofline_pct(ctx, "fit.ordering") is None


@pytest.mark.parametrize("name, is_launch", [
    ("cudaLaunchKernel", True), ("cudaLaunchKernelExC", True),
    ("cuLaunchKernel", True), ("cuLaunchKernelEx", True),
    ("cudaGraphLaunch", True), ("cudaLaunchCooperativeKernel", True),
    ("cudaMemcpyAsync", False), ("cudaStreamSynchronize", False)])
def test_launch_calls(name, is_launch):
    assert tracing.is_launch_call(name) is is_launch


class _Kineto:
    """A profiler event as older releases give it: no activity type."""

    def __init__(self, name, dev, start, dur, corr=0, linked=0, user=False):
        self._v = (name, dev, start, dur, corr, linked, user)

    def name(self):
        return self._v[0]

    def device_type(self):
        return "DeviceType.CUDA" if self._v[1] else "DeviceType.CPU"

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def linked_correlation_id(self):
        return self._v[5]

    def is_user_annotation(self):
        return self._v[6]


def test_from_kineto_without_activity_types():
    ev = tracing.from_kineto([
        _Kineto("lingambench.op", False, 0, 100, user=True),
        _Kineto("fit.ordering", False, 10, 50, user=True),
        _Kineto("cudaLaunchKernel", False, 20, 2, corr=5),
        _Kineto("cuLaunchKernel", False, 30, 2, corr=6),
        _Kineto("aten::mm", False, 40, 5, corr=900),
        _Kineto("fit.ordering", True, 21, 40),        # its mirror on the card
        _Kineto("pair_partials_kernel<4>", True, 25, 10, corr=6, linked=1),
        _Kineto("Memcpy HtoD (Pageable -> Device)", True, 50, 3, corr=7),
    ])
    got = sorted((e.kind, e.name, e.device_kind) for e in ev)
    assert got == sorted([
        ("range", "lingambench.op", ""), ("range", "fit.ordering", ""),
        ("launch", "cudaLaunchKernel", ""), ("launch", "cuLaunchKernel", ""),
        ("op", "aten::mm", ""),
        ("device", "pair_partials_kernel<4>", "kernel"),
        ("device", "Memcpy HtoD (Pageable -> Device)", "gpu_memcpy")])
    s = tracing.summarize(ev, ["fit.ordering"])
    assert s.device_s_in("fit.ordering") == pytest.approx(10e-9)
    assert (s.kernels, s.kernels_with_launch, s.launch_calls) == (1, 1, 2)
    assert tracing.kinds(ev)["device:kernel"] == 1
