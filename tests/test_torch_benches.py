"""The port's engine benches (``benchmarks/torch_{tune,stream,bootstrap,
drift,infer,sharded,profile}.py``) and their runner on the CPU, against
the JAX package's benches.

Where a bench's numbers depend on the fits (stream, bootstrap, drift),
both benches run here at one tiny size: their data generators are
monkeypatched to the same smaller draw (the port's generators return the
reference's arrays bit for bit), and the bootstrap's resample indices on
the port's side are the reference's (``jax.random`` and a
``torch.Generator`` draw different streams). Where a bench reports only
times and plans (tune, infer, profile), the port's rows are held to the
reference bench's committed artifact at the same quick size
(``BENCH_kernels.json``, ``BENCH_infer.json``, ``BENCH_profile.json``):
the same cells, row keys and identifying fields. Times are never
compared. The sharded bench is held to the port's own local plan at
(256, 24) over four gloo ranks; its reference parity is pinned by
``tests/test_torch_mesh.py``.

Tolerances: orders exact (tie-free draws); stream edges and the
per-kind drift facts exact; bootstrap edge probabilities exact (the same
indices, the same orders); the rolling adjacency within 1e-4 of the
scratch fit's (``ATOL_STREAM``); queries' effects within 1e-5 of
max(1, |T|) of the reference's.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import (bench_bootstrap, bench_drift, bench_infer,
                        bench_stream, torch_bootstrap, torch_drift,
                        torch_infer, torch_profile, torch_run, torch_sharded,
                        torch_stream, torch_tune)
from repro.core import batched as jbatched
from repro.data import simulate as jsimulate
from repro.infer import effects as jeffects
from repro.stream import StreamConfig as JStreamConfig
from repro_torch.analysis import report
from repro_torch.core import batched
from repro_torch.infer import effects

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL_STREAM = 1e-4


def _committed(stem):
    with open(os.path.join(ROOT, f"BENCH_{stem}.json")) as f:
        return json.load(f)


def _record(monkeypatch, module, name):
    """Wrap ``module.name`` to record each call's result."""
    calls = []
    real = getattr(module, name)

    def rec(*a, **k):
        out = real(*a, **k)
        calls.append(out)
        return out

    monkeypatch.setattr(module, name, rec)
    return calls


def test_tune_bench_covers_the_reference_cells():
    got = torch_tune.run(quick=True, device="cpu")
    want = _committed("kernels")
    assert len(got["rows"]) == len(want["rows"])
    for g, w in zip(got["rows"], want["rows"]):
        assert set(w) <= set(g)
        assert (g["op"], g["shape"]) == (w["op"], w["shape"])
        assert g["reference_backend"] == w["backend"]
        assert g["backend"] == {"pallas": "cuda"}.get(w["backend"],
                                                      w["backend"])
        assert g["bucket"].startswith(w["bucket"])
        if g["backend"] == "blocked":  # nothing tunable: one candidate
            assert g["n_candidates"] == 1
            assert g["speedup_vs_heuristic"] == 1.0
            assert "one candidate" in g["note"]
        else:
            assert g["n_candidates"] > 1
        assert g["launches"] == {"B1": 0, "B2": 0, "B3": 0}  # plain on CPU


def test_tune_bench_b3_cell_through_the_repaired_runner(monkeypatch):
    cell = [c for c in torch_tune.FULL_CELLS if c[0] == "fused_moment_sums"]
    monkeypatch.setattr(torch_tune, "FULL_CELLS", cell)
    (row,) = torch_tune.run(quick=False, device="cpu")["rows"]
    assert row["n_candidates"] == 1 and row["tuned"]["variant"] == "cuda-fused"
    assert row["tuned"]["us"] > 0.0
    chk = row["b3_check"]
    # On the CPU the runner's one plan is B3's plain version itself.
    assert chk["sums_equal_direct_launch"] and chk["sums_equal_plain"]
    assert chk["max_abs_err_vs_plain_per_sample"] == 0.0
    assert chk["within_tolerance"]


def test_stream_bench_matches_reference_bench(monkeypatch):
    d_small = 8

    def small(m, d, seed):
        return jsimulate.simulate_var_stocks(m=m, d=d_small, edge_prob=0.3,
                                             seed=seed)

    monkeypatch.setattr(bench_stream, "simulate_var_stocks", small)
    monkeypatch.setattr(torch_stream, "simulate_var_stocks", small)
    monkeypatch.setattr(bench_stream, "StreamConfig",
                        lambda **kw: JStreamConfig(**{**kw, "d": d_small}))
    sizes = torch_stream.sizes
    monkeypatch.setattr(torch_stream, "sizes",
                        lambda quick: {**sizes(quick), "d": d_small})
    want_fits = _record(monkeypatch, bench_stream, "_scratch_window_fit")
    got_fits = _record(monkeypatch, torch_stream, "_scratch_window_fit")
    want = bench_stream.run(quick=True)
    got = torch_stream.run(quick=True, device="cpu")
    assert set(want) <= set(got)
    for key in ("window_rows", "chunk", "window_chunks", "lags", "streams",
                "slides", "order_match_last_window", "edges_last_window"):
        assert got[key] == want[key], key
    assert got["d"] == d_small
    assert got["order_match_last_window"] and got["parting_step_last_window"] \
        is None and got["order_tie_or_match_last_window"]
    assert got["adj_max_diff_last_window"] <= ATOL_STREAM
    # Every scratch fit (warm-ups and timed windows, both configs): the
    # reference's order, thetas within the stream tolerance.
    assert len(got_fits) == len(want_fits)
    for (g, g_thetas, _), (w, w_thetas) in zip(got_fits, want_fits):
        np.testing.assert_array_equal(g.order.numpy(), np.asarray(w.order))
        for a, b in zip(g_thetas, w_thetas):
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       atol=ATOL_STREAM)
    assert got["launches"] == {"B1": 0, "B2": 0, "B3": 0}


def test_bootstrap_bench_matches_reference_bench(monkeypatch):
    cells = [("tiny", 400, 6, 4), ("tiny-wide", 300, 9, 3)]
    for module in (bench_bootstrap, torch_bootstrap):
        monkeypatch.setattr(module, "_cells", lambda quick: cells)
    monkeypatch.setattr(
        batched, "resample_indices",
        lambda seed, n, m, device: torch.as_tensor(
            np.array(jbatched.resample_indices(seed, n, m)), device=device))
    want_res = _record(monkeypatch, bench_bootstrap, "bootstrap_lingam")
    got_res = _record(monkeypatch, torch_bootstrap, "bootstrap_lingam")
    want = bench_bootstrap.run(quick=True)
    got = torch_bootstrap.run(quick=True, device="cpu")
    assert len(got["rows"]) == len(want) == len(cells)
    for g, w in zip(got["rows"], want):
        assert set(w) <= set(g)
        for key in ("cell", "m", "d", "n_sampling", "edge_prob_agree"):
            assert g[key] == w[key], key
        assert g["edge_prob_agree"] and g["edge_prob_max_diff"] == 0.0
    # Warm-ups and timed runs alike: the reference's edge probabilities.
    assert len(got_res) == len(want_res)
    for g, w in zip(got_res, want_res):
        np.testing.assert_array_equal(g.edge_prob, np.asarray(w.edge_prob))
        np.testing.assert_allclose(g.coef_mean, np.asarray(w.coef_mean),
                                   atol=1e-5)


def test_drift_bench_matches_reference_bench(monkeypatch):
    def breaks(m, d, kind, seed, at):
        return jsimulate.simulate_var_breaks(m=2400, d=d, kind=kind,
                                             seed=seed, at=1200)

    stocks = jsimulate.simulate_var_stocks

    def stationary(m, d, seed):
        return stocks(m=2400, d=d, seed=seed)

    monkeypatch.setattr(bench_drift, "simulate_var_breaks", breaks)
    monkeypatch.setattr(torch_drift, "simulate_var_breaks", breaks)
    # The reference bench imports this generator inside ``run``.
    monkeypatch.setattr(jsimulate, "simulate_var_stocks", stationary)
    monkeypatch.setattr(torch_drift, "simulate_var_stocks", stationary)
    want = bench_drift.run(quick=True)
    got = torch_drift.run(quick=True, device="cpu")
    assert set(want) <= set(got)
    for key in ("d", "chunk", "window_chunks", "runs_per_kind", "per_kind",
                "false_alarm_per_chunk", "fixed_refits", "adaptive_refits",
                "adaptive_final_cadence", "adaptive_alerts_stationary"):
        assert got[key] == want[key], key
    assert got["fixed_refit_s"] > 0.0 and got["adaptive_refit_s"] > 0.0


def test_infer_bench_covers_the_reference_cells():
    got = torch_infer.run(quick=True, device="cpu")
    want = _committed("infer")
    assert len(got["rows"]) == len(want["rows"])
    for g, w in zip(got["rows"], want["rows"]):
        assert set(w) <= set(g)
        for key in ("kind", "d", "n_queries", "n_rows"):
            assert g.get(key) == w.get(key), key
        assert g["max_rel_diff_batched_vs_loop"] <= 1e-5
    assert set(got["speedup_effects"]) == set(want["speedup_effects"])
    assert got["launches"] == {"B1": 0, "B2": 0, "B3": 0}


@pytest.mark.parametrize("d,seed", [(64, 64), (256, 256), (64, 1)])
def test_infer_bench_graphs_and_effects_match_reference(d, seed):
    got = torch_infer._synthetic_graphs(d, 3, seed, "cpu")
    want = bench_infer._synthetic_graphs(d, 3, seed)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.order.numpy(), np.asarray(w.order))
        np.testing.assert_array_equal(g.adjacency.numpy(),
                                      np.asarray(w.adjacency))
        t = effects.total_effects_impl(g.adjacency, g.order).numpy()
        jt = np.asarray(jeffects.total_effects_impl(
            jnp.asarray(w.adjacency), jnp.asarray(w.order)))
        assert np.abs(t - jt).max() <= 1e-5 * max(1.0, np.abs(jt).max())


def test_profile_bench_covers_the_reference_rows():
    got = torch_profile.run(quick=True, device="cpu")
    want = _committed("profile")
    assert (got["m"], got["d"]) == (want["m"], want["d"])
    assert [r["stage"] for r in got["rows"]] == \
        [r["stage"] for r in want["rows"]]
    for row in got["rows"]:
        assert set(report.STAGE_KEYS) <= set(row)
        assert row["best_s"] > 0.0
    # On the CPU only the plain variant's kernel row runs.
    assert [r["variant"] for r in got["kernels"]] == ["blocked-rows"]
    assert got["launches"] == {"B1": 0, "B2": 0, "B3": 0}


@pytest.fixture(scope="module")
def sharded():
    """The 2 x 2 and 4 x 1 meshes at (256, 24): one world of four gloo
    ranks on the CPU."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch_sharded, "sizes", lambda quick: (256, 24, 64))
        return torch_sharded.run(device="cpu", meshes=("2x2", "4x1"))


@pytest.mark.parametrize("mesh", ["2x2", "4x1"])
def test_sharded_bench_orders_equal_the_local_plan(sharded, mesh):
    (row,) = [r for r in sharded["rows"] if r["mesh"] == mesh]
    assert (row["m"], row["d"], row["ranks"]) == (256, 24, 4)
    assert row["collectives"] == "ok"
    assert row["collective_backend"] == "gloo"
    assert row["order_matches_oracle"] and row["order_n_disagree"] == 0
    assert row["parting_step"] is None and row["order_tie_or_match"]
    assert row["fit_order_matches_oracle"]
    for key in ("order_s", "fit_s", "oracle_order_s", "order_step_ms"):
        assert row[key] > 0.0, key
    # On the CPU the ranks run the plain version: no launch.
    assert row["b2_launches_per_rank"] == [0, 0, 0, 0]


def test_sharded_bench_row_keys_cover_the_reference(sharded):
    want = _committed("sharded")["rows"][0]
    for row in sharded["rows"]:
        assert set(want) <= set(row)
    assert "not scaling" in sharded["note"]


@pytest.mark.parametrize("name", ["tune", "stream", "bootstrap", "drift",
                                  "infer", "sharded", "profile"])
def test_engine_benches_raise_without_a_card(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_run.BENCHES[name]()


def test_runner_lists_the_reference_benches():
    from benchmarks import run as jrun

    assert list(torch_run.BENCHES) == list(jrun.BENCHES)
    assert {n: f"BENCH_torch_{s}.json" for n, s in
            torch_run.ARTIFACTS.items()} == {
        n: f"BENCH_torch_{s}.json" for n, s in jrun.ARTIFACTS.items()}


def test_runner_writes_a_profile_artifact_that_smoke_reads(tmp_path):
    assert torch_run.main(["--only", "profile", "--device", "cpu",
                           "--out-dir", str(tmp_path), "--profile"]) == 0
    payload = json.loads((tmp_path / "BENCH_torch_profile.json").read_text())
    for key in ("m", "d", "rows", "kernels", "device", "provenance",
                "hardware", "bench", "quick", "profile"):
        assert key in payload, key
    assert payload["bench"] == "profile" and payload["quick"]
    assert payload["hardware"] == {"platform": "cpu"}
    assert report.smoke(tmp_path) == 0


def test_runner_exits_nonzero_and_writes_nothing_for_a_failed_bench(
        tmp_path, monkeypatch, capsys):
    def broken(quick=True, device="cuda"):
        raise ValueError("bench broke")

    monkeypatch.setattr(torch_run, "BENCHES",
                        {"tune": broken, "infer": torch_infer.run})
    assert torch_run.main(["--device", "cpu",
                           "--out-dir", str(tmp_path)]) == 1
    # The failed bench wrote no artifact; the next one still ran.
    assert not (tmp_path / "BENCH_torch_kernels.json").exists()
    assert (tmp_path / "BENCH_torch_infer.json").exists()
    captured = capsys.readouterr()
    assert "bench broke" in captured.err
    assert "FAILED" in captured.out


def test_stamp_rows_joins_records_by_op_and_shape():
    payload = {"rows": [{"op": "a", "shape": [2, 3]},
                        {"op": "a", "shape": [4, 5]}, {"op": "b"}]}
    snap = {"records": [{"op": "a", "shape": [4, 5], "flops": 7.0,
                         "roofline_frac": 0.5},
                        {"op": "b", "shape": [1], "bytes": 3.0}]}
    out = torch_run.stamp_rows(payload, snap)
    assert "flops" not in out["rows"][0]
    assert out["rows"][1]["flops"] == 7.0
    assert out["rows"][1]["roofline_frac"] == 0.5
    assert out["rows"][2]["bytes"] == 3.0
    assert out["profile"] is snap
