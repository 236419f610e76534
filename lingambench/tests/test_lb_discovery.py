"""A configuration, a traffic mix, a cell and a metric added as new files
only, in a copy: the harness runs them without an edit to a file that
was there."""

import hashlib
import json

from lingambench.tests import helpers


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in (root / "lingambench").rglob("*") if p.is_file()
            and "__pycache__" not in p.parts}


def test_new_cell_and_metric_as_files(tmp_path):
    root = helpers.tiny_checkout(tmp_path)
    bench = root / "lingambench"
    before = _digests(root)
    (bench / "configs" / "tiny-laplace.json").write_text(json.dumps({
        "name": "tiny-laplace", "m": 1500, "d": 6,
        "data": {"generator": "simulate_lingam",
                 "params": {"n_layers": 2, "edge_prob": 0.5,
                            "noise": "laplace", "min_effect": 0.3}}}))
    (bench / "traffic" / "direct-fit-2.json").write_text(json.dumps({
        "driver": "direct_fit", "trace_ops": 2}))
    (bench / "limits" / "tiny-laplace.fit.json").write_text(json.dumps({
        "limits": {"order_gap": {"limit": 1e-6},
                   "adjacency_err": {"limit": 1e-3}}}))
    (bench / "metrics" / "fits_done.py").write_text(
        "def read(ctx, metric):\n    return float(ctx.n_ops)\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tiny-laplace", "source": "test",
                            "file": "lingambench/configs/tiny-laplace.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "tiny-laplace.fit",
                              "config": "tiny-laplace",
                              "traffic": "direct-fit-2", "chips": 1,
                              "why": "test"})
    spec["end_to_end"].append({"name": "fits_done", "unit": "fits",
                               "better": "higher", "bound": 0.01,
                               "source": "host_clock",
                               "workloads": ["tiny-laplace.fit"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    after = _digests(root)
    assert all(after[k] == v for k, v in before.items())

    rc, out, err, last = helpers.run_cell(root, "tiny-laplace.fit",
                                          seconds=0.5)
    assert rc == 0, err
    assert last["correct"] is True
    assert set(last["metrics"]) == {"fits_done", "setup_s"}
    assert last["metrics"]["fits_done"]["value"] == last["attempted"]
