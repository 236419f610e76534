"""Port's batched engine and bootstrap against the JAX reference, on the
same numpy inputs, and against the port's own per-dataset fits.

The reference runs on the CPU as its own tests run it: ``blocked``
backend, tuning off, ``vmap`` over fits. The port runs on the CPU
(``device="cpu"``), where the moment dispatch takes the CUDA kernel's
plain version. The two draw bootstrap indices from different generators,
so the parity tests hand the reference's ``resample_indices`` to both.

Tolerances: causal orders and edge probabilities exact (well-separated
simulated data); adjacency, residual variances and coefficient
statistics within 1e-5 (XLA and torch reduce in different orders). The
port's batch against its own per-element runs: the kernel's plain sums
bit for bit, and fits equal to the per-dataset fits.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import api as japi
from repro.core import batched as jbatched
from repro.core import bootstrap as jbootstrap
from repro_torch.core import DirectLiNGAM, api, batched, bootstrap
from repro_torch.data.simulate import simulate_lingam
from repro_torch.kernels import ops, pairwise_stats

torch.set_num_threads(1)

ATOL = 1e-5


def _jconfig(compaction="none"):
    return japi.FitConfig(backend="blocked", tune="off",
                          compaction=compaction)


def _stack(seeds, m, d):
    return np.stack([simulate_lingam(m=m, d=d, seed=s).data for s in seeds])


@pytest.mark.parametrize("compaction", ["none", "staged"])
def test_fit_many_matches_reference(compaction):
    xs = _stack(range(3), 2000, 7)
    got = batched.fit_many(torch.from_numpy(xs),
                           api.FitConfig(compaction=compaction))
    want = jbatched.fit_many(jnp.asarray(xs), _jconfig(compaction))
    order, adj, rv = got.to_numpy()
    assert order.shape == (3, 7) and adj.shape == (3, 7, 7)
    np.testing.assert_array_equal(order, np.asarray(want.order))
    np.testing.assert_allclose(adj, np.asarray(want.adjacency), atol=ATOL)
    np.testing.assert_allclose(rv, np.asarray(want.resid_var), atol=ATOL)


@pytest.mark.parametrize("compaction", ["none", "staged"])
def test_fit_many_equals_per_dataset_fits(compaction):
    """Each element of the batch is the fit of that dataset alone: the
    same order, and pruning on the same data and order."""
    xs = torch.from_numpy(_stack(range(3), 600, 9))
    cfg = api.FitConfig(compaction=compaction, min_stage=3)
    many = batched.fit_many(xs, cfg)
    for k, one in enumerate(api.fit_fn(x, cfg) for x in xs):
        assert torch.equal(many.order[k], one.order)
        assert torch.equal(many.adjacency[k], one.adjacency)
        assert torch.equal(many.resid_var[k], one.resid_var)


def test_fit_many_from_stats_matches_reference():
    xs = _stack(range(2), 1500, 6)
    x64 = xs.astype(np.float64)
    means = x64.mean(axis=1).astype(np.float32)
    covs = np.stack([np.cov(x, rowvar=False, ddof=0)
                     for x in x64]).astype(np.float32)
    cfg = api.FitConfig(compaction="staged", moment_chunk=256)
    got = batched.fit_many_from_stats(
        *(torch.from_numpy(a) for a in (xs, means, covs)), cfg)
    want = jbatched.fit_many_from_stats(
        jnp.asarray(xs), jnp.asarray(means), jnp.asarray(covs),
        japi.FitConfig(backend="blocked", tune="off", compaction="staged",
                       moment_chunk=256))
    order, adj, rv = got.to_numpy()
    np.testing.assert_array_equal(order, np.asarray(want.order))
    np.testing.assert_allclose(adj, np.asarray(want.adjacency), atol=ATOL)
    np.testing.assert_allclose(rv, np.asarray(want.resid_var), atol=ATOL)
    for k in range(2):
        one = api.fit_from_stats(*(torch.from_numpy(a[k])
                                   for a in (xs, means, covs)), cfg)
        assert torch.equal(got.order[k], one.order)
        assert torch.equal(got.adjacency[k], one.adjacency)


def _row_sums(result):
    """A per-resample reduction, written once for each side."""
    return result.adjacency.sum(-1)


def _jrow_sums(result):
    return result.adjacency.sum(-1)


@pytest.mark.parametrize("compaction", ["none", "staged"])
def test_bootstrap_fits_match_reference_on_its_indices(compaction):
    gt = simulate_lingam(m=500, d=6, seed=4)
    idx = np.array(jbatched.resample_indices(0, 6, 500))
    cfg = api.FitConfig(compaction=compaction)
    x = torch.from_numpy(np.ascontiguousarray(gt.data))
    got = batched.bootstrap_fits(x, torch.from_numpy(idx).long(), cfg)
    want = jbatched.bootstrap_fits(gt.data, jnp.asarray(idx),
                                   config=_jconfig(compaction))
    np.testing.assert_array_equal(got.order.numpy(), np.asarray(want.order))
    coefs, jcoefs = got.adjacency.numpy(), np.asarray(want.adjacency)
    res = bootstrap._summarize(coefs, 0.1)
    jres = jbootstrap._summarize(jcoefs, 0.1)
    np.testing.assert_array_equal(res.edge_prob, jres.edge_prob)
    np.testing.assert_allclose(res.coef_mean, jres.coef_mean, atol=ATOL)
    np.testing.assert_allclose(res.coef_std, jres.coef_std, atol=ATOL)

    fits, sums = batched.bootstrap_fits_with(
        x, torch.from_numpy(idx).long(), cfg, _row_sums)
    jfits, jsums = jbatched.bootstrap_fits_with(
        gt.data, jnp.asarray(idx), _jconfig(compaction), _jrow_sums)
    assert torch.equal(fits.adjacency, got.adjacency)
    assert sums.shape == (6, 6)
    np.testing.assert_allclose(sums.numpy(), np.asarray(jsums), atol=ATOL)


@pytest.mark.parametrize("compaction", ["none", "staged"])
def test_vmap_bootstrap_matches_loop(compaction):
    """Same seed + same explicit config => identical resamples, identical
    edge probabilities and coefficients across strategies."""
    gt = simulate_lingam(m=500, d=6, seed=4)
    config = api.FitConfig(compaction=compaction)
    kw = dict(n_sampling=6, threshold=0.1, seed=0, config=config,
              device="cpu")
    res_v = bootstrap.bootstrap_lingam(gt.data, strategy="vmap", **kw)
    res_l = bootstrap.bootstrap_lingam(gt.data, strategy="loop", **kw)
    np.testing.assert_array_equal(res_v.edge_prob, res_l.edge_prob)
    np.testing.assert_allclose(res_v.coef_mean, res_l.coef_mean, atol=ATOL)
    np.testing.assert_allclose(res_v.coef_std, res_l.coef_std, atol=ATOL)


def test_default_strategies_agree_on_edge_prob():
    """Shipped defaults (vmap + staged against loop + full scan): the same
    causal orders, so the same edge probabilities."""
    gt = simulate_lingam(m=800, d=12, seed=1)
    kw = dict(n_sampling=5, threshold=0.1, seed=3, device="cpu")
    res_v = bootstrap.bootstrap_lingam(gt.data, strategy="vmap", **kw)
    res_l = bootstrap.bootstrap_lingam(gt.data, strategy="loop", **kw)
    np.testing.assert_array_equal(res_v.edge_prob, res_l.edge_prob)


def test_auto_strategy_falls_back_to_loop_on_memory(monkeypatch):
    """auto = vmap when ~4x the resample stack fits the budget, else loop;
    both fit the same resamples."""
    taken = []
    real = batched.bootstrap_fits
    monkeypatch.setattr(batched, "bootstrap_fits",
                        lambda *a, **k: taken.append("vmap") or real(*a, **k))
    gt = simulate_lingam(m=400, d=5, seed=3)
    kw = dict(n_sampling=3, threshold=0.1, seed=0, device="cpu")
    res_loop = bootstrap.bootstrap_lingam(gt.data, max_vmap_bytes=1, **kw)
    assert taken == []
    res_vmap = bootstrap.bootstrap_lingam(gt.data, **kw)
    assert taken == ["vmap"]
    np.testing.assert_array_equal(res_loop.edge_prob, res_vmap.edge_prob)
    # The reference's budget rule, at its edge: 16 n m d bytes.
    bootstrap.bootstrap_lingam(gt.data, max_vmap_bytes=16 * 3 * 400 * 5, **kw)
    bootstrap.bootstrap_lingam(gt.data, max_vmap_bytes=16 * 3 * 400 * 5 - 1,
                               **kw)
    assert taken == ["vmap", "vmap"]
    with pytest.raises(ValueError, match="strategy"):
        bootstrap.bootstrap_lingam(gt.data, strategy="sometimes", **kw)


def test_resolve_config_matches_reference():
    model = DirectLiNGAM(prune_method="adaptive_lasso", prune_threshold=0.05,
                         prune_kwargs={"lam": 0.02}, compaction="staged",
                         backend="blocked")
    cfg = bootstrap._resolve_config(None, model, None, "vmap")
    assert cfg == model.to_config()
    assert cfg.prune_kwargs_dict == {"lam": 0.02}
    for strategy in ("vmap", "loop"):
        got = bootstrap._resolve_config(None, None, None, strategy)
        want = jbootstrap._resolve_config("blocked", None, None, strategy)
        assert got.compaction == want.compaction
        assert got.backend is None
    explicit = api.FitConfig(backend="ref")
    assert bootstrap._resolve_config(None, model, explicit,
                                     "loop") is explicit


def test_resample_indices_deterministic_on_a_device():
    a = batched.resample_indices(7, 4, 100, device="cpu")
    b = batched.resample_indices(7, 4, 100, device="cpu")
    assert torch.equal(a, b) and a.shape == (4, 100)
    assert int(a.min()) >= 0 and int(a.max()) < 100
    assert not torch.equal(a, batched.resample_indices(8, 4, 100,
                                                       device="cpu"))


def test_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = simulate_lingam(m=200, d=4, seed=0).data
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bootstrap.bootstrap_lingam(x, n_sampling=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        batched.resample_indices(0, 2, 200)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        batched.warmup_fit_many((200, 4))


def test_warmup_and_input_checks():
    batched.warmup_fit_many((300, 5), api.FitConfig(compaction="staged"),
                            batch=2, device="cpu")
    with pytest.raises(ValueError, match=r"\(b, m, d\)"):
        batched.fit_many(torch.zeros(100, 4))
    assert [batched.pow2_bucket(n, 16) for n in (1, 3, 8, 9, 40)] == [
        jbatched.pow2_bucket(n, 16) for n in (1, 3, 8, 9, 40)]


def _batch(b, m, d, seed):
    rng = np.random.default_rng(seed)
    xs = torch.stack([ops.standardize(torch.from_numpy(
        rng.laplace(size=(m, d)).astype(np.float32))) for _ in range(b)])
    cs = torch.stack([ops.correlation(x) for x in xs])
    return xs.contiguous(), cs.contiguous()


@pytest.mark.parametrize("b,m,d", [(3, 257, 10), (2, 777, 40), (1, 130, 5)])
def test_batched_plain_moments_equal_per_element(b, m, d):
    """The wrappers' batched plain versions (the CPU side of one batched
    launch) equal the per-element calls bit for bit, for B1, the row
    tile and the slab-structured B2, and the dispatch entries."""
    xs, cs = _batch(b, m, d, seed=m + d)
    row0, rows = 1, d - 2
    batched_calls = {
        "b1": pairwise_stats.pairwise_moments(xs, cs),
        "b1_split": pairwise_stats.pairwise_moments(xs, cs, n_split=3),
        "rows": pairwise_stats.pairwise_moment_sums_rows(xs, cs, row0, rows),
        "slabs": pairwise_stats.pairwise_moment_sums_slabs(xs, cs, 96),
        "chunked": ops.pairwise_moment_sums_chunked(xs, cs, chunk=96),
        "chunked_blocked": ops.pairwise_moment_sums_chunked(
            xs, cs, chunk=96, backend="blocked"),
        "means_chunked": ops.pairwise_moments_chunked(xs, cs, chunk=128),
        "ops_blocked": ops.pairwise_moments(xs, cs, backend="blocked"),
        "ops_ref": ops.pairwise_moments(xs, cs, backend="ref"),
        "rows_blocked": ops.pairwise_moment_sums_rows(xs, cs, row0, rows,
                                                      backend="blocked"),
    }
    for k in range(b):
        x, c = xs[k], cs[k]
        single = {
            "b1": pairwise_stats.pairwise_moments(x, c),
            "b1_split": pairwise_stats.pairwise_moments(x, c, n_split=3),
            "rows": pairwise_stats.pairwise_moment_sums_rows(x, c, row0,
                                                             rows),
            "slabs": pairwise_stats.pairwise_moment_sums_slabs(x, c, 96),
            "chunked": ops.pairwise_moment_sums_chunked(x, c, chunk=96),
            "chunked_blocked": ops.pairwise_moment_sums_chunked(
                x, c, chunk=96, backend="blocked"),
            "means_chunked": ops.pairwise_moments_chunked(x, c, chunk=128),
            "ops_blocked": ops.pairwise_moments(x, c, backend="blocked"),
            "ops_ref": ops.pairwise_moments(x, c, backend="ref"),
            "rows_blocked": ops.pairwise_moment_sums_rows(
                x, c, row0, rows, backend="blocked"),
        }
        for name, (s1, s2) in single.items():
            g1, g2 = batched_calls[name]
            assert torch.equal(g1[k], s1) and torch.equal(g2[k], s2), name


def test_batched_kernel_inputs_are_checked():
    xs, cs = _batch(2, 200, 6, seed=0)
    with pytest.raises(ValueError, match=r"\(b, d, d\)"):
        pairwise_stats.pairwise_moments(xs, cs[0])
    with pytest.raises(ValueError, match="must be"):
        pairwise_stats.pairwise_moments(xs, cs[:1])
    with pytest.raises(ValueError, match="outside"):
        pairwise_stats.pairwise_moment_sums_rows(xs, cs, 4, 5)
