"""The monitored stream on the CPU at a tiny size: the row-by-row float64
statistics against the port's from moments, the alert emulation against
a freshly armed monitor, ``monitor_alert_diff``'s rules, the sound
program correct (a ring that fills included), its faults not, the
control above the program, and the monitor's span reader."""

import json
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from lingambench.lib import reference_monitor, roofline, tracing
from lingambench.lib.tracing import Event
from lingambench.metrics import monitor_device_ms
from lingambench.tests import helpers

CELL = "varlingam-stocks-487.monitored-stream"
TRAFFIC = "traffic/monitored-rolling-8.json"


def _tiny_checkout(tmp_path, **monitor):
    """The tiny copy, 3 sessions of 8 chunks; a threshold of 0.5 so that
    a tiny window's posts fire alerts."""
    root = helpers.tiny_checkout(tmp_path)
    path = root / "lingambench" / TRAFFIC
    mon = json.loads(path.read_text())["monitor"]
    mon.update({"threshold": 0.5, **monitor})
    helpers.edit_json(path, {"sessions": 3, "panel_chunks": 8,
                             "check_sessions": 3, "monitor": mon})
    return root


def _graph(rng, d, lags=1):
    b0 = np.tril(rng.normal(scale=0.5, size=(d, d)), -1) * (
        rng.random((d, d)) < 0.4)
    return {"a": torch.as_tensor(0.2 * rng.normal(size=(d, lags * d))),
            "intercept": torch.as_tensor(rng.normal(scale=0.1, size=d)),
            "b0": torch.as_tensor(b0),
            "resid_var": torch.as_tensor(rng.uniform(0.5, 2.0, size=d))}


def _cfg():
    return dict(json.loads((helpers.BENCH / TRAFFIC).read_text())["monitor"])


def test_the_traffic_carries_the_monitors_defaults():
    import dataclasses

    from repro_torch.stream import MonitorConfig

    assert _cfg() == dataclasses.asdict(MonitorConfig())


@pytest.mark.parametrize("lags", [1, 2])
def test_row_by_row_statistics_equal_the_monitors_from_moments(lags):
    """The float64 statistics from the chunk's rows equal the port's
    ``chunk_drift_stats`` from the same rows' float64 moments, within the
    float32 rounding of the port's sqrt(n / 2) (the count is float32)."""
    from repro_torch.stream import monitor, stats, window

    rng = np.random.default_rng(lags)
    d = 9
    rows = rng.laplace(size=(256 + lags, d))
    graph = _graph(rng, d, lags)
    aug = torch.as_tensor(window.lagged_rows(rows, lags))
    st = stats.from_chunk(aug.double())
    got = reference_monitor.chunk_stats(rows, lags, graph)
    want = monitor.chunk_drift_stats(
        st.count.double(), aug.mean(0), (aug - aug.mean(0)).T
        @ (aug - aug.mean(0)), graph["a"], graph["intercept"], graph["b0"],
        graph["resid_var"])
    np.testing.assert_allclose(got, torch.stack(want).numpy(), rtol=1e-7,
                               atol=1e-9)


def test_alerts_equal_a_freshly_armed_monitors():
    """The levels and firing order a monitor armed just before the chunk
    gives, kind by kind and variables ascending."""
    from repro_torch.stream import MonitorConfig, monitor

    d = 12
    rng = np.random.default_rng(5)
    z = rng.normal(scale=12.0, size=(3, d))
    mon = monitor.GraphHealthMonitor(MonitorConfig(), d, 1)
    g = _graph(rng, d)
    mon.graph = monitor.ServedGraph(a=g["a"].float(),
                                    intercept=g["intercept"].float(),
                                    b0=g["b0"].float(),
                                    order=torch.arange(d),
                                    resid_var=g["resid_var"].float())
    alerts = mon._absorb(256.0, z.astype(np.float32), 1, 0)
    got = [(reference_monitor.KINDS.index(a.kind), a.variable)
           for a in alerts]
    assert got == reference_monitor.fired(reference_monitor.levels(z, _cfg()),
                                          _cfg())
    assert len(got) > 3


def test_alert_diff_counts_extra_and_owed_pairs():
    cfg = dict(_cfg(), max_pending=3)
    h = cfg["threshold"]
    level = np.zeros((3, 6))
    level[1, [0, 2, 4, 5]] = h + 1.0
    level[2, 3] = h + 5e-4           # within LEVEL_TOL: either way
    diff = reference_monitor.alert_diff
    # a full ring keeps the newest 3: owed from its first pair on
    assert diff([(1, 2), (1, 4), (1, 5)], level, cfg) == 0
    assert diff([(1, 4), (1, 5), (2, 3)], level, cfg) == 0
    assert diff([(1, 0), (1, 4), (1, 5)], level, cfg) == 1   # (1, 2) owed
    # below the ring's size every sure pair is owed
    assert diff([(1, 4), (1, 5)], level, cfg) == 2
    assert diff([(1, 0), (1, 2), (1, 4), (1, 5), (0, 1)],
                level, dict(cfg, max_pending=64)) == 1       # (0, 1) extra


@pytest.mark.parametrize("max_pending", [64, 4])
def test_the_sound_program_is_correct(tmp_path, max_pending):
    root = _tiny_checkout(tmp_path, max_pending=max_pending)
    rc, out, err, last = helpers.run_cell(root, CELL, seconds=0.5)
    assert rc == 0, err
    assert last["correct"] is True, last["checks"]
    assert set(last["checks"]) == {"order_gap", "var_coef_err",
                                   "stale_refits", "monitor_z_err",
                                   "monitor_alert_diff"}
    assert set(last["metrics"]) == {"slide_s", "setup_s"}
    assert "'drawn_alerts': 0.0" not in err


STAT_OFF = """
from repro_torch.serve import engine
_poll = engine.CausalDiscoveryEngine.poll_alerts
def poll_alerts(self, sid=None):
    out = _poll(self, sid)
    for a in out:
        a.stat += 1e-3 * max(1.0, abs(a.stat))
    return out
engine.CausalDiscoveryEngine.poll_alerts = poll_alerts
"""

DROPPED_ALERT = """
from repro_torch.serve import engine
_poll = engine.CausalDiscoveryEngine.poll_alerts
def poll_alerts(self, sid=None):
    out = _poll(self, sid)
    by_sid = {}
    for a in out:
        by_sid.setdefault(a.sid, []).append(a)
    drop = {id(v[len(v) // 2]) for v in by_sid.values()}
    return [a for a in out if id(a) not in drop]
engine.CausalDiscoveryEngine.poll_alerts = poll_alerts
"""


@pytest.mark.parametrize("max_pending", [64, 4])
@pytest.mark.parametrize("fault", [STAT_OFF, DROPPED_ALERT],
                         ids=["stat-off", "dropped-alert"])
def test_a_fault_is_not_correct(tmp_path, fault, max_pending):
    root = _tiny_checkout(tmp_path, max_pending=max_pending)
    rc, out, err, last = helpers.run_cell(root, CELL, seconds=0.5,
                                          prelude=fault)
    assert rc == 0, err
    assert last["correct"] is False, last["checks"]


def test_the_control_reads_far_above_the_program(tmp_path):
    """bfloat16 products stand in for the control's TF32 on the CPU: its
    statistics read far above the sound program's on the same post."""
    root = _tiny_checkout(tmp_path)
    code = (f"import sys; sys.path[:0] = [{str(root)!r}, "
            f"{str(helpers.SRC)!r}]\n"
            "import torch\n"
            "from lingambench.lib import reference_monitor\n"
            "reference_monitor.main(['--seeds', '7', '--modes', "
            "'bfloat16'], device=torch.device('cpu'))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=root)
    (line,) = [json.loads(s) for s in proc.stdout.splitlines()]
    assert line["alerts"] > 0, proc.stderr
    assert line["numbers"]["monitor_z_err"] > \
        100 * line["program"]["monitor_z_err"]


def test_monitor_reader_reads_the_monitor_range():
    """Device milliseconds per operation of the kernels launched inside
    ``stream.monitor``; nothing where the port has no such span."""
    metric = types.SimpleNamespace(name="monitor_device_ms.monstream")

    def ctx(range_name):
        ev = [Event("range", "lingambench.op", 0.0, 10.0),
              Event("range", range_name, 2.0, 3.0),
              Event("launch", "cudaLaunchKernel", 2.1, 2.11, corr=1),
              Event("device", "gemm", 2.2, 2.25, corr=1,
                    device_kind="kernel"),
              Event("launch", "cudaLaunchKernel", 5.0, 5.01, corr=2),
              Event("device", "other", 5.1, 5.6, corr=2,
                    device_kind="kernel")]
        s = tracing.summarize(ev, ["lingambench.op",
                                   *monitor_device_ms.RANGES])
        return types.SimpleNamespace(
            trace=s, n_ops=1, shapes=[(2048, 487, 8)],
            peaks=types.SimpleNamespace(sfu_per_s=roofline.sfu_rate(
                132, 1.98e9), bytes_per_s=3.35e12))

    assert monitor_device_ms.read(ctx("stream.monitor"), metric) == \
        pytest.approx(50.0)
    assert monitor_device_ms.read(ctx("stream.other"), metric) is None
