"""The last line: its keys, the checks last, and a whole run on the CPU
at a tiny size that prints it."""

import json

import pytest

from lingambench.lib import report
from lingambench.tests import helpers

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def test_result_line_keys_and_checks_last():
    checks = report.compare({"order_gap": 1e-12, "adjacency_err": 2e-6},
                          {"order_gap": {"limit": 1e-9},
                           "adjacency_err": {"limit": 1e-4}})
    line = report.result_line(
        correct=report.passed(checks), attempted=3, failed=0,
        metrics={"fit_s": {"value": 2.25, "unit": "s"}},
        device={"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
                "count": 1, "memory_peak_bytes": 123},
        breakdown={"device_ops": [], "idle_gaps": []}, checks=checks)
    obj = json.loads(line)
    assert list(obj) == KEYS + ["breakdown", "checks"]
    assert obj["correct"] is True
    assert obj["checks"]["order_gap"] == {"value": 1e-12, "limit": 1e-9}


@pytest.mark.parametrize("numbers, ok", [
    ({"a": 0.5, "b": 0.0}, True),
    ({"a": 1.5, "b": 0.0}, False),          # over its limit
    ({"a": 0.5}, False),                    # a number missing
    ({"a": float("nan"), "b": 0.0}, False),  # not a number
    ({"a": 1.0, "b": 0.0}, True),           # at the limit
])
def test_passed(numbers, ok):
    checks = report.compare(numbers, {"a": {"limit": 1.0}, "b": {"limit": 0}})
    assert report.passed(checks) is ok


@pytest.mark.parametrize("trace", [0, 1])
def test_a_run_prints_the_line(tmp_path, trace):
    root = helpers.tiny_checkout(tmp_path)
    rc, out, err, last = helpers.run_cell(root, "lingam-1m-100.fit",
                                          seconds=0.5, trace=trace)
    assert rc == 0, err
    assert list(last)[:5] == KEYS and list(last)[-1] == "checks"
    assert last["correct"] is True and last["failed"] == 0
    assert last["attempted"] >= 1
    want = {"setup_s", "fit_s"} if not trace else set()
    assert set(last["metrics"]) == want      # no card: no device metric
    assert all(m["value"] > 0 for m in last["metrics"].values())
    # each compared number beside its limit, last on standard error too
    tail = err.strip().splitlines()[-len(last["checks"]):]
    assert [t.split()[1] for t in tail] == list(last["checks"])


def test_no_card_no_result(tmp_path):
    """Without a card the command exits nonzero and prints no result."""
    import subprocess
    import sys

    root = helpers.tiny_checkout(tmp_path)
    (root / "src").symlink_to(helpers.SRC)
    proc = subprocess.run(
        [sys.executable, "lingambench/run.py", "--workload",
         "lingam-1m-100.fit", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, cwd=root,
        timeout=300)
    if proc.returncode == 0:
        pytest.skip("this machine has a card")
    assert proc.stdout.strip() == ""
    assert "no card" in proc.stderr


def test_missing_port_no_result(tmp_path):
    """In a directory with only BENCHMARK.json and the benchmark's files
    the command exits nonzero and prints no result."""
    import subprocess
    import sys

    root = helpers.tiny_checkout(tmp_path)
    proc = subprocess.run(
        [sys.executable, "lingambench/run.py", "--workload",
         "lingam-1m-100.fit", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, cwd=root,
        timeout=300, env={"PATH": "/usr/bin:/bin", "PYTHONPATH": ""})
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
