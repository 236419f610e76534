"""Port's VarLiNGAM and chunked-moment fits against the JAX reference.

The reference runs on the CPU as its own tests run it: ``blocked``
backend, tuning off. The port runs on the CPU (``device="cpu"``), where
the moment kernels take their plain versions.

Tolerances: causal orders exact (tie-free simulated data); VAR
coefficients, intercepts, residuals and thetas within 1e-4 (two float32
least-squares solvers); a chunked fit's adjacency within 1e-5 of the
unchunked one (the moments differ only in float32 summation order, and
the adjacency does not depend on them once the order is fixed).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import lingam_workloads as jworkloads
from repro.core import api as japi
from repro.core import var_lingam as jvar
from repro.data import simulate as jsimulate
from repro_torch.configs import lingam_workloads
from repro_torch.core import VarLiNGAM, api, fit_var_lingam, ordering
from repro_torch.core.var_lingam import estimate_var
from repro_torch.data.simulate import simulate_lingam, simulate_var_stocks
from repro_torch.kernels import pairwise_stats

torch.set_num_threads(1)

ATOL_VAR = 1e-4


@pytest.mark.parametrize("m,d,edge_prob,seed", [(300, 9, 0.3, 0),
                                                (200, 20, 0.01, 4)])
def test_simulate_var_stocks_copy_matches_reference(m, d, edge_prob, seed):
    got = simulate_var_stocks(m=m, d=d, edge_prob=edge_prob, seed=seed)
    want = jsimulate.simulate_var_stocks(m=m, d=d, edge_prob=edge_prob,
                                         seed=seed)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_stream_workload_is_the_full_stream_benchmark_setting():
    assert lingam_workloads.WORKLOADS["varlingam-stocks-487"] == (
        lingam_workloads.LingamWorkload(
            "varlingam-stocks-487", 4_000, 487,
            jworkloads.WORKLOADS["varlingam-stocks-487"].description))
    w = lingam_workloads.STREAM_WORKLOADS["varlingam-stream-487"]
    # benchmarks/bench_stream.py run(quick=False): d=487, chunk=256,
    # window_chunks=8, lags=1, refit_every=1.
    assert (w.d, w.chunk, w.window_chunks, w.lags, w.refit_every) == (
        487, 256, 8, 1, 1)


def test_moment_chunk_config_validation():
    with pytest.raises(ValueError, match="moment_chunk"):
        api.FitConfig(backend="ref", moment_chunk=64)
    with pytest.raises(ValueError, match="moment_chunk"):
        api.FitConfig(backend="blocked", moment_chunk=0)
    for backend in (None, "cuda", "blocked"):
        assert api.FitConfig(backend=backend, moment_chunk=1).moment_chunk == 1
    # The reference validates the same way.
    with pytest.raises(ValueError, match="moment_chunk"):
        japi.FitConfig(backend="ref", moment_chunk=64)


@pytest.mark.parametrize("compaction", ["none", "staged"])
def test_moment_chunk_fit_reproduces_plain_fit(compaction):
    gt = simulate_lingam(m=900, d=7, seed=2)
    x = torch.from_numpy(gt.data)
    cfg = api.FitConfig(compaction=compaction)
    plain = api.fit_fn(x, cfg)
    before = pairwise_stats.rows_launches
    chunked = api.fit_fn(x, dataclasses.replace(cfg, moment_chunk=128))
    assert pairwise_stats.rows_launches == before  # CPU: plain versions
    np.testing.assert_array_equal(chunked.order.numpy(), plain.order.numpy())
    np.testing.assert_allclose(chunked.adjacency.numpy(),
                               plain.adjacency.numpy(), atol=1e-5)
    want = japi.fit_fn(jnp.asarray(gt.data), japi.FitConfig(
        backend="blocked", tune="off", compaction=compaction,
        moment_chunk=128))
    np.testing.assert_array_equal(chunked.order.numpy(),
                                  np.asarray(want.order))
    np.testing.assert_allclose(chunked.adjacency.numpy(),
                               np.asarray(want.adjacency), atol=1e-5)


@pytest.mark.parametrize("seed", [0, 5])
def test_staged_equals_masked_on_the_chunked_path(seed):
    gt = simulate_lingam(m=1500, d=13, seed=seed)
    x = torch.from_numpy(gt.data)
    for backend in (None, "blocked"):
        reducer = ordering.LocalReducer(backend=backend, moment_chunk=96)
        masked = ordering.full_width_order_impl(x, reducer).numpy()
        staged = ordering.compact_order_impl(x, reducer, min_stage=3).numpy()
        np.testing.assert_array_equal(staged, masked)


def _var_data():
    return simulate_var_stocks(m=600, d=6, edge_prob=0.3, seed=1)


@pytest.mark.parametrize("lags", [1, 2])
def test_estimate_var_matches_reference(lags):
    x, _, _ = _var_data()
    mats, intercept, resid = estimate_var(torch.from_numpy(x), lags)
    jmats, jintercept, jresid = jvar.estimate_var(jnp.asarray(x), lags)
    assert mats.shape == (lags, 6, 6) and resid.shape == (600 - lags, 6)
    for g, w in ((mats, jmats), (intercept, jintercept), (resid, jresid)):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL_VAR)


@pytest.mark.parametrize("compaction", ["none", "staged"])
def test_var_lingam_matches_reference(compaction):
    x, b0, _ = _var_data()
    got = VarLiNGAM(device="cpu", compaction=compaction).fit(x)
    want = jvar.VarLiNGAM(backend="blocked", tune="off",
                          compaction=compaction).fit(jnp.asarray(x))
    np.testing.assert_array_equal(got.causal_order_, want.causal_order_)
    assert len(got.adjacency_matrices_) == 2
    for g, w in zip(got.adjacency_matrices_, want.adjacency_matrices_):
        np.testing.assert_allclose(g, w, atol=ATOL_VAR)
    np.testing.assert_allclose(got.var_coefs_, want.var_coefs_,
                               atol=ATOL_VAR)
    np.testing.assert_allclose(got.residuals_, want.residuals_,
                               atol=ATOL_VAR)
    # The wrapper function is the facade.
    again = fit_var_lingam(x, device="cpu", compaction=compaction)
    np.testing.assert_array_equal(again.causal_order_, got.causal_order_)


def test_var_lingam_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x, _, _ = _var_data()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        VarLiNGAM().fit(x)
