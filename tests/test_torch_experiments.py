"""The port's paper benchmarks (``benchmarks/torch_*.py``) at tiny sizes on
the CPU, against the JAX package's benchmarks at the same sizes.

The reference benches fix their sizes inside ``run``; both sides are
shrunk alike by swapping their data generator for one that returns a
smaller draw of the same family (the port's generators return the
reference's arrays bit for bit). Orders are held exact on these tie-free
draws. Tolerances: DirectLiNGAM's F1 and SHD exact; I-NLL / I-MAE of the
same graph within 1e-4 relative (float32 pruning on both sides, the SVGD
particles from the reference's own draw); NOTEARS, GOLEM and ICA-LiNGAM
F1 exact on these draws (the same steps from the same start; ICA-LiNGAM's
starting rows differ, but its estimate does not depend on them here).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import bench_equivalence, bench_gene, bench_notears
from benchmarks import bench_stocks
from benchmarks import (torch_equivalence, torch_gene, torch_notears,
                        torch_speedup, torch_stocks)
from repro.core import ordering as jordering
from repro.data import simulate as jsimulate
from repro_torch.core import ordering
from repro_torch.data import simulate

torch.set_num_threads(1)


def test_speedup_rows_on_cpu():
    row = torch_speedup.shape_row(600, 5, torch.device("cpu"), reps=1)
    for key in ("sequential_s", "kernel_ordering_s", "blocked_ordering_s",
                "fit_s", "speedup", "ordering_share",
                "b1_launches_per_ordering", "orders_equal_sequential"):
        assert key in row, key
    cpu = torch_speedup.host_cpu()
    assert cpu["threads"] >= 1 and cpu["machine"]
    assert 0.0 < row["ordering_share"] < 1.0
    # On the CPU the wrapper takes the kernel's plain version: no launch.
    assert row["b1_launches_per_ordering"] == 0
    gt = jsimulate.simulate_lingam(m=600, d=5, seed=0)
    want = np.asarray(jordering.causal_order(jnp.asarray(gt.data),
                                             backend="blocked"))
    got = ordering.causal_order(torch.from_numpy(
        np.ascontiguousarray(gt.data))).numpy()
    np.testing.assert_array_equal(got, want)
    assert row["orders_equal_sequential"] and row["orders_equal_blocked"]


def test_parting_tie_measures_the_parting():
    gt = simulate.simulate_lingam(m=800, d=5, seed=0)
    x = torch.from_numpy(np.ascontiguousarray(gt.data))
    order = ordering.causal_order(x).numpy()
    assert torch_equivalence.parting_tie(
        x, order, order, ordering.LocalReducer()) == (None, 0.0)
    swapped = order.copy()
    swapped[[0, 1]] = swapped[[1, 0]]
    p, ratio = torch_equivalence.parting_tie(
        x, order, swapped, ordering.LocalReducer())
    assert p == 0 and ratio > 1.0  # a clear root is no tie


def test_equivalence_matches_reference_bench():
    got = torch_equivalence.run(n_sims=2, device="cpu")
    want = bench_equivalence.run(n_sims=2)
    for key in ("n_sims", "order_match_rate", "f1_mean", "recall_mean",
                "shd_mean"):
        assert got[key] == pytest.approx(want[key], abs=1e-12), key
    assert got["parting_gap_ratio_max"] <= 1.0


def test_notears_bench_matches_reference_bench(monkeypatch):
    def small(m, d, seed):
        return jsimulate.simulate_lingam(m=600, d=4, seed=seed + 4)

    monkeypatch.setattr(bench_notears, "simulate_lingam", small)
    monkeypatch.setattr(torch_notears, "simulate_lingam", small)
    for module in (bench_notears, torch_notears):
        monkeypatch.setattr(module, "LAMS", (0.001,))
    got = torch_notears.run(n_sims=1, device="cpu")
    want = bench_notears.run(n_sims=1)
    for key in ("notears_f1", "notears_recall", "notears_shd",
                "directlingam_f1", "golem_f1", "ica_lingam_f1"):
        assert got[key] == pytest.approx(want[key], abs=1e-12), key
    assert set(got["seconds_per_sim"]) == {"notears_grid", "directlingam",
                                           "golem", "ica_lingam"}


def test_gene_bench_matches_reference_bench(monkeypatch):
    def small(m, d, n_interventions, seed):
        return jsimulate.simulate_gene_perturb(
            m=800, d=20, n_interventions=n_interventions, seed=seed)

    monkeypatch.setattr(bench_gene, "simulate_gene_perturb", small)
    monkeypatch.setattr(torch_gene, "simulate_gene_perturb", small)
    draw = np.array(jax.random.normal(jax.random.key(0), (32, 1)))
    got = torch_gene.run(device="cpu", particles=draw)
    want = bench_gene.run()
    assert (got["m"], got["d"]) == (800, 20)
    for name in ("directlingam", "notears"):
        for key in ("inll", "imae"):
            assert got[name][key] == pytest.approx(want[name][key],
                                                   rel=1e-4), (name, key)
        assert np.isfinite(got[name]["noise_scale"])
    assert got["directlingam"]["b1_launches"] == 0  # plain version on CPU


def test_gene_noise_scale_draws_on_the_device_without_particles():
    data = torch_gene.gene_data(quick=True)
    b = np.zeros((data.x.shape[1],) * 2, np.float32)
    s = torch_gene.noise_scale_posterior(b, data.x_train[:200], "cpu")
    emp = np.std(data.x_train[:200], axis=0).mean()
    assert abs(s - emp) < 0.1 * emp


def test_stocks_bench_matches_reference_bench(monkeypatch):
    def small(m, d, seed):
        return jsimulate.simulate_var_stocks(m=600, d=8, edge_prob=0.3,
                                             seed=seed)

    monkeypatch.setattr(bench_stocks, "simulate_var_stocks", small)
    monkeypatch.setattr(torch_stocks, "simulate_var_stocks", small)
    got = torch_stocks.run(device="cpu")
    want = bench_stocks.run()
    for key in ("in_degree_mean", "out_degree_mean", "top_exerting",
                "top_receiving", "leaf_nodes", "b0_precision", "b0_recall"):
        assert got[key] == want[key], key
    assert got["fit_s"] > 0.0


@pytest.mark.parametrize("run", [
    lambda: torch_speedup.run(),
    lambda: torch_equivalence.run(n_sims=1),
    lambda: torch_notears.run(n_sims=1),
    lambda: torch_gene.run(),
    lambda: torch_stocks.run(),
])
def test_benches_raise_without_a_card(run, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run()
