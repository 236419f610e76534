"""BENCHMARK.json keeps to the form the benchmark's contract sets: keys,
names, units, lengths, and a reader and a limits file for what it
names."""

import importlib
import json
import re

import pytest

from lingambench.tests import helpers

SPEC = json.loads((helpers.CHECKOUT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRIC_KEYS = {"name", "unit", "better", "source"}


def _line(s):
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "lingambench/run.py"]
    assert SPEC["paths"] == ["lingambench"]
    assert isinstance(SPEC["run_seconds"], int)
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len((helpers.CHECKOUT / "BENCHMARK.json").read_bytes()) <= 65536


def test_configs_and_cells():
    names = set()
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["why"])
        assert _line(c["source"]) and c["file"].startswith("lingambench/")
        assert (helpers.CHECKOUT / c["file"]).is_file()
        names.add(c["name"])
    pairs = set()
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] in (1, 4)
        assert _line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert (helpers.BENCH / "traffic" / f"{w['traffic']}.json").is_file()
        assert (helpers.BENCH / "limits" / f"{w['name']}.json").is_file()
    assert {c["config"] for c in SPEC["workloads"]} == names


def _cells(metric):
    return metric.get("workloads", [w["name"] for w in SPEC["workloads"]])


def test_metrics():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    seen = set()
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["name"] not in seen
        seen.add(m["name"])
        importlib.import_module(
            "lingambench.metrics." + m["name"].split(".")[0])
    for m in SPEC["end_to_end"]:
        assert set(m) <= METRIC_KEYS | {"bound", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for m in SPEC["per_layer"]:
        assert set(m) <= METRIC_KEYS | {"layer", "moves", "workloads"}
        assert _line(m["layer"]) and m["moves"] in e2e
        assert set(_cells(m)) <= set(_cells(e2e[m["moves"]]))
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for w in SPEC["workloads"]:
        reported = [m for m in SPEC["end_to_end"] if w["name"] in _cells(m)]
        assert len(reported) >= 2
        assert any(w["name"] in _cells(m) for m in SPEC["per_layer"])


@pytest.mark.parametrize("path", sorted(
    p.relative_to(helpers.CHECKOUT).as_posix()
    for p in helpers.BENCH.rglob("*") if p.is_file()
    and "__pycache__" not in p.parts))
def test_file_names_use_name_characters(path):
    assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", path)
