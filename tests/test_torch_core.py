"""Port's ordering, pruning, functional API and facade against the JAX
reference, on the same numpy inputs.

The reference runs on the CPU as its own tests run it: ``blocked``
backend, tuning off. The port runs on the CPU (``device="cpu"``), where
the moment dispatch takes the CUDA kernel's plain version.

Tolerances: causal orders exact (well-separated simulated data);
adjacency and residual variances within 1e-5 (XLA and torch reduce in
different orders); moments-derived quantities as stated per test.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.baselines import sequential_lingam as seq
from repro.configs import lingam_workloads as jworkloads
from repro.core import api as japi
from repro.core import measures as jmeasures
from repro.core import ordering as jordering
from repro.data import simulate as jsimulate
from repro_torch.configs import lingam_workloads
from repro_torch.core import DirectLiNGAM, api, measures, ordering, pruning
from repro_torch.data.simulate import simulate_lingam
from repro_torch.kernels import pairwise_stats

torch.set_num_threads(1)

ATOL_FIT = 1e-5
SRC = Path(__file__).resolve().parents[1] / "src"


def _jreducer():
    return jordering.LocalReducer(backend="blocked", tune="off")


def _order_consistent(order, b_true):
    """No edge may point from a later to an earlier variable."""
    d = len(order)
    pos = np.empty(d, int)
    pos[np.asarray(order)] = np.arange(d)
    src, dst = np.nonzero(b_true)
    return bool(np.all(pos[dst] < pos[src]))


def _f1(b_est, b_true, thresh=0.1):
    e = np.abs(b_est) > thresh
    t = b_true != 0
    tp, fp, fn = np.sum(e & t), np.sum(e & ~t), np.sum(~e & t)
    prec, rec = tp / max(tp + fp, 1), tp / max(tp + fn, 1)
    return 2 * prec * rec / max(prec + rec, 1e-12)


@pytest.mark.parametrize("seed", [0, 3])
def test_simulate_copy_matches_reference(seed):
    got = simulate_lingam(m=300, d=9, seed=seed)
    want = jsimulate.simulate_lingam(m=300, d=9, seed=seed)
    np.testing.assert_array_equal(got.data, want.data)
    np.testing.assert_array_equal(got.adjacency, want.adjacency)
    np.testing.assert_array_equal(got.order, want.order)


def test_workload_table_copy_matches_reference():
    got = {k: (w.m, w.d) for k, w in lingam_workloads.WORKLOADS.items()}
    want = {k: (w.m, w.d) for k, w in jworkloads.WORKLOADS.items()}
    assert got == want
    assert got["lingam-1m-100"] == (1_000_000, 100)


def test_entropy_from_moments_matches_reference():
    rng = np.random.default_rng(0)
    m1 = rng.uniform(0.2, 0.5, size=(6, 6)).astype(np.float32)
    m2 = rng.uniform(-0.3, 0.3, size=(6, 6)).astype(np.float32)
    got = measures.entropy_from_moments(torch.from_numpy(m1),
                                        torch.from_numpy(m2))
    want = jmeasures.entropy_from_moments(jnp.asarray(m1), jnp.asarray(m2))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    assert (measures.K1, measures.K2, measures.GAMMA) == (
        jmeasures.K1, jmeasures.K2, jmeasures.GAMMA)


def test_step_standardize_matches_reference():
    # Large column means: the two-pass variance must not cancel.
    x = np.random.default_rng(1).uniform(size=(800, 6)).astype(np.float32)
    x = x * np.float32(0.5) + np.float32(1000.0)
    got = ordering.step_standardize(torch.from_numpy(x),
                                    ordering.LocalReducer())
    want = jordering.step_standardize(jnp.asarray(x), _jreducer())
    for g, w, atol in zip(got, want, (1e-3, 1e-4, 1e-3, 1e-7)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=atol,
                                   rtol=1e-5)
    c = got[1].numpy()
    np.testing.assert_allclose(np.diag(c), 1.0, atol=1e-5)


def test_ordering_step_matches_reference():
    gt = simulate_lingam(m=1500, d=8, seed=2)
    active = np.array([True, True, False, True, True, True, False, True])
    x_new, act_new, root = ordering.ordering_step(
        torch.from_numpy(gt.data), torch.from_numpy(active),
        ordering.LocalReducer())
    jx_new, jact_new, jroot = jordering.ordering_step(
        jnp.asarray(gt.data), jnp.asarray(active), _jreducer())
    assert int(root) == int(jroot)
    np.testing.assert_array_equal(act_new.numpy(), np.asarray(jact_new))
    np.testing.assert_allclose(x_new.numpy(), np.asarray(jx_new), atol=1e-5,
                               rtol=1e-5)
    # The step's scores, through the moments of both implementations.
    x_std, c, _, _ = ordering.step_standardize(torch.from_numpy(gt.data),
                                               ordering.LocalReducer())
    reducer = ordering.LocalReducer()
    scores = ordering.step_scores(*reducer.col_moments(x_std),
                                  *reducer.moment_rows(x_std, c),
                                  torch.from_numpy(active))
    jxs, jc, _, _ = jordering.step_standardize(jnp.asarray(gt.data),
                                               _jreducer())
    jscores = jordering.step_scores(*_jreducer().col_moments(jxs),
                                    *_jreducer().moment_rows(jxs, jc),
                                    jnp.asarray(active))
    np.testing.assert_allclose(scores.numpy(), np.asarray(jscores),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_causal_order_matches_reference_and_sequential(seed):
    gt = simulate_lingam(m=2000, d=7, seed=seed)
    got = ordering.causal_order(torch.from_numpy(gt.data)).numpy()
    want = np.asarray(jordering.masked_order_impl(jnp.asarray(gt.data),
                                                  _jreducer()))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, seq.causal_order_sequential(gt.data))
    blocked = ordering.causal_order(torch.from_numpy(gt.data),
                                    backend="blocked").numpy()
    np.testing.assert_array_equal(blocked, got)


@pytest.mark.parametrize("d,frac,min_stage", [(100, 0.25, 8), (13, 0.25, 3),
                                              (7, 0.5, 1), (5, 1.0, 8)])
def test_stage_schedule_matches_reference(d, frac, min_stage):
    assert ordering._stage_schedule(d, frac, min_stage) == (
        jordering._stage_schedule(d, frac, min_stage))


@pytest.mark.parametrize("seed", [0, 5])
def test_staged_compaction_equals_masked_scan(seed):
    gt = simulate_lingam(m=1500, d=13, seed=seed)
    x = torch.from_numpy(gt.data)
    masked = ordering.causal_order(x).numpy()
    staged = ordering.causal_order_compact(x, min_stage=3).numpy()
    np.testing.assert_array_equal(staged, masked)


@pytest.mark.parametrize("method,kwargs", [("ols", {}),
                                           ("adaptive_lasso", {"lam": 0.05})])
def test_fit_fn_matches_reference(method, kwargs):
    gt = simulate_lingam(m=3000, d=8, seed=4)
    cfg = api.FitConfig(prune_method=method, prune_kwargs=kwargs)
    got = api.fit_fn(torch.from_numpy(gt.data), cfg)
    want = japi.fit_fn(jnp.asarray(gt.data), japi.FitConfig(
        backend="blocked", tune="off", prune_method=method,
        prune_kwargs=kwargs))
    order, adj, rv = got.to_numpy()
    np.testing.assert_array_equal(order, np.asarray(want.order))
    np.testing.assert_allclose(adj, np.asarray(want.adjacency), atol=ATOL_FIT)
    np.testing.assert_allclose(rv, np.asarray(want.resid_var), atol=ATOL_FIT)

    # Pruning alone, from the reference's order.
    ref_order = api.FitResult.from_numpy(
        np.asarray(want.order), np.asarray(want.adjacency),
        np.asarray(want.resid_var), device="cpu").order
    fin = api.finish_fit(torch.from_numpy(gt.data), ref_order, cfg)
    np.testing.assert_allclose(fin.adjacency.numpy(),
                               np.asarray(want.adjacency), atol=ATOL_FIT)
    np.testing.assert_allclose(fin.resid_var.numpy(),
                               np.asarray(want.resid_var), atol=ATOL_FIT)


def test_ols_matches_sequential_baseline():
    gt = simulate_lingam(m=3000, d=8, seed=6)
    order = seq.causal_order_sequential(gt.data)
    b = pruning.ols_adjacency(torch.from_numpy(gt.data),
                              torch.from_numpy(order))
    np.testing.assert_allclose(b.numpy(),
                               seq.ols_adjacency_sequential(gt.data, order),
                               atol=1e-4)


@pytest.mark.parametrize("method", ["ols", "adaptive_lasso"])
def test_fit_from_stats_matches_reference(method):
    gt = simulate_lingam(m=2000, d=7, seed=8)
    x = gt.data.astype(np.float64)
    mean = x.mean(axis=0).astype(np.float32)
    cov = np.cov(x, rowvar=False, ddof=0).astype(np.float32)
    got = api.fit_from_stats(torch.from_numpy(gt.data),
                             torch.from_numpy(mean), torch.from_numpy(cov),
                             api.FitConfig(prune_method=method))
    want = japi.fit_from_stats(gt.data, mean, cov, japi.FitConfig(
        backend="blocked", tune="off", prune_method=method))
    order, adj, rv = got.to_numpy()
    np.testing.assert_array_equal(order, np.asarray(want.order))
    np.testing.assert_allclose(adj, np.asarray(want.adjacency), atol=ATOL_FIT)
    np.testing.assert_allclose(rv, np.asarray(want.resid_var), atol=ATOL_FIT)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_facade_on_cpu_recovers_true_dag(seed):
    gt = simulate_lingam(m=5000, d=10, seed=seed)
    model = DirectLiNGAM(device="cpu", prune_threshold=0.1).fit(gt.data)
    assert _order_consistent(model.causal_order_, gt.adjacency)
    assert _f1(model.adjacency_, gt.adjacency) > 0.9


def test_fit_result_numpy_round_trip():
    res = api.FitResult.from_numpy([2, 0, 1], np.eye(3), np.ones(3),
                                 device="cpu")
    order, adj, rv = res.to_numpy()
    assert res.order.dtype == torch.long
    assert res.adjacency.dtype == torch.float32
    np.testing.assert_array_equal(order, [2, 0, 1])
    np.testing.assert_array_equal(adj, np.eye(3))
    np.testing.assert_array_equal(rv, np.ones(3))


def test_no_card_fit_raises_instead_of_running_on_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ran = []
    monkeypatch.setattr(api, "fit_fn", lambda *a, **k: ran.append(1))
    x = simulate_lingam(m=200, d=4, seed=0).data
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DirectLiNGAM().fit(x)
    assert not ran


def test_fit_result_from_numpy_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.FitResult.from_numpy([0, 1], np.eye(2), np.ones(2))


def test_backend_names():
    x = torch.from_numpy(simulate_lingam(m=300, d=4, seed=0).data)
    before = pairwise_stats.launches
    with pytest.raises(ValueError, match="cuda"):
        api.fit_fn(x, api.FitConfig(backend="cuda"))
    with pytest.raises(ValueError, match="'cuda'"):
        api.FitConfig(backend="pallas")
    with pytest.raises(ValueError):
        api.FitConfig(compaction="sometimes")
    assert pairwise_stats.launches == before
    assert not api.tf32_enabled()  # PyTorch's default: full fp32


def test_port_imports_neither_jax_nor_reference():
    modules = sorted(
        ".".join(p.relative_to(SRC).with_suffix("").parts).removesuffix(
            ".__init__")
        for p in (SRC / "repro_torch").rglob("*.py")
    )
    code = (
        "import importlib, sys\n"
        f"for name in {modules!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'jaxlib', 'repro') or n.startswith('jax'))\n"
        "print(len(bad), bad)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "0 []", out.stdout
    assert "repro_torch.kernels.pairwise_stats" in modules


def test_scripts_beside_the_port_import_neither_jax_nor_reference():
    """chip_smoke.py, the port's benchmarks and its examples import only
    the port (and numpy, scipy, the standard library)."""
    root = SRC.parent
    files = sorted([root / "chip_smoke.py",
                    *(root / "benchmarks").glob("torch_*.py"),
                    *(root / "examples").glob("torch_*.py")])
    assert len(files) >= 10, files
    code = (
        "import importlib.util, sys\n"
        f"for i, path in enumerate({[str(f) for f in files]!r}):\n"
        "    spec = importlib.util.spec_from_file_location(f'm{i}', path)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'jaxlib', 'repro') or n.startswith('jax'))\n"
        "print(len(bad), bad)\n"
    )
    env = dict(os.environ, PYTHONPATH=f"{SRC}:{root}")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=root,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "0 []", out.stdout
