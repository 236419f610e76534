"""Port's effect and intervention queries against the JAX reference, on
the same numpy inputs.

Each test hands the same fitted graph (a reference fit carried over with
``FitResult.from_numpy``) or the same numpy arrays to both sides; the
port runs on the CPU. Tolerance: 1e-5 absolute (float32 triangular
solves in different libraries), exact where the result is a mask or a
gather.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import api as japi
from repro.core import batched as jbatched
from repro.infer import effects as jeffects
from repro.infer import intervene as jintervene
from repro.stream import stats as jstats
from repro_torch.core import api, batched
from repro_torch.core.var_lingam import VarLiNGAM
from repro_torch.data.simulate import simulate_lingam, simulate_var_stocks
from repro_torch.infer import effects, intervene
from repro_torch.stream import stats

torch.set_num_threads(1)

ATOL = 1e-5
_JCFG = japi.FitConfig(backend="blocked", tune="off", compaction="staged")


def _fits(seed, m=3000, d=9):
    """(data, the reference's fit, the same fit as the port's result)."""
    gt = simulate_lingam(m=m, d=d, seed=seed)
    want = japi.fit_fn(jnp.asarray(gt.data), _JCFG)
    got = api.FitResult.from_numpy(np.asarray(want.order),
                                   np.asarray(want.adjacency),
                                   np.asarray(want.resid_var), device="cpu")
    return gt, want, got


@pytest.mark.parametrize("seed", [0, 3])
def test_total_effects_match_reference(seed):
    _, want, got = _fits(seed)
    t = effects.total_effects(got).numpy()
    np.testing.assert_allclose(t, np.asarray(jeffects.total_effects(want)),
                               atol=ATOL)
    np.testing.assert_allclose(
        t, np.linalg.inv(np.eye(t.shape[0]) - got.adjacency.double().numpy()),
        atol=ATOL)
    assert np.allclose(np.diagonal(t), 1.0)


def test_total_effects_of_a_batch_equal_each_fit():
    xs = torch.from_numpy(np.stack([simulate_lingam(m=1500, d=7, seed=s).data
                                    for s in range(3)]))
    fits = batched.fit_many(xs, api.FitConfig(compaction="staged"))
    many = effects.total_effects(fits)
    for k, one in enumerate(fits.unbind()):
        np.testing.assert_allclose(many[k].numpy(),
                                   effects.total_effects(one).numpy(),
                                   atol=1e-6)


def test_target_effects_row_matches_reference():
    _, want, got = _fits(1)
    full = effects.total_effects(got).numpy()
    for target in (0, 4, 8):
        row = effects.target_effects_row(got.adjacency, got.order, target)
        jrow = jeffects.target_effects_row(want.adjacency, want.order, target)
        np.testing.assert_allclose(row.numpy(), np.asarray(jrow), atol=ATOL)
        np.testing.assert_allclose(row.numpy(), full[target], atol=ATOL)


def test_target_effects_row_of_a_batch_equals_each_fit():
    xs = torch.from_numpy(np.stack([simulate_lingam(m=1500, d=7, seed=s).data
                                    for s in range(3)]))
    fits = batched.fit_many(xs, api.FitConfig(compaction="staged"))
    full = effects.total_effects(fits)
    for target in (0, 6, torch.tensor(3)):
        rows = effects.target_effects_row(fits.adjacency, fits.order, target)
        assert rows.shape == (3, 7)
        for k, one in enumerate(fits.unbind()):
            np.testing.assert_allclose(
                rows[k].numpy(),
                effects.target_effects_row(one.adjacency, one.order,
                                           target).numpy(), atol=1e-6)
            np.testing.assert_allclose(rows[k].numpy(),
                                       full[k, int(target)].numpy(),
                                       atol=ATOL)


@pytest.mark.parametrize("nodes", [[1], [0, 4, 5]])
def test_path_specific_effects_match_reference(nodes):
    _, want, got = _fits(2)
    mask = np.zeros(9, bool)
    mask[nodes] = True
    for fn, jfn in ((effects.effects_avoiding, jeffects.effects_avoiding),
                    (effects.effects_through, jeffects.effects_through)):
        out = fn(got.adjacency, got.order, torch.from_numpy(mask))
        jout = jfn(want.adjacency, want.order, jnp.asarray(mask))
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=ATOL)
    # A chain 0 -> 1 -> 2 and the direct edge 0 -> 2, blocked at 1.
    b = torch.zeros(3, 3)
    b[1, 0], b[2, 1], b[2, 0] = 0.5, 0.8, 0.3
    order = torch.arange(3)
    blocked = torch.tensor([False, True, False])
    assert float(effects.effects_avoiding(b, order, blocked)[2, 0]) == (
        pytest.approx(0.3))
    assert float(effects.effects_through(b, order, blocked)[2, 0]) == (
        pytest.approx(0.4))


@pytest.mark.parametrize("k,horizon", [(1, 4), (2, 6)])
def test_var_irf_matches_reference(k, horizon):
    rng = np.random.default_rng(k)
    d = 5
    perm = rng.permutation(d)
    b_ord = np.tril(rng.normal(size=(d, d)) * 0.4, k=-1)
    b0 = np.zeros((d, d), np.float32)
    b0[np.ix_(perm, perm)] = b_ord  # lower triangular in the order perm
    mats = (rng.normal(size=(k, d, d)) * 0.15).astype(np.float32)
    got = effects.var_irf(b0, torch.from_numpy(perm), mats, horizon,
                          device="cpu")
    want = jeffects.var_irf(b0, jnp.asarray(perm), mats, horizon)
    assert got.shape == (horizon + 1, d, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_var_irf_of_the_facade_matches_reference():
    """The facade's numpy outputs passed straight in, as a user calls it."""
    x, _, _ = simulate_var_stocks(m=1500, d=5, edge_prob=0.3, seed=3)
    model = VarLiNGAM(device="cpu").fit(x)
    args = (model.adjacency_matrices_[0], model.causal_order_,
            model.var_coefs_, 5)
    got = effects.var_irf(*args, device="cpu")
    assert got.device.type == "cpu" and got.shape == (6, 5, 5)
    want = jeffects.var_irf(*(jnp.asarray(a) for a in args[:3]), 5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_var_irf_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        effects.var_irf(np.zeros((3, 3), np.float32), np.arange(3),
                        np.zeros((1, 3, 3), np.float32), 2)


def test_graph_surgery_and_noise_stats_match_reference():
    gt, want, got = _fits(4, d=7)
    mask, values = intervene.do_arrays(7, {2: 1.5, 5: -0.5})
    jmask, jvalues = jintervene.do_arrays(7, {2: 1.5, 5: -0.5})
    np.testing.assert_array_equal(mask, jmask)
    np.testing.assert_array_equal(values, jvalues)
    np.testing.assert_array_equal(
        intervene.mutilate(got.adjacency, torch.from_numpy(mask)).numpy(),
        np.asarray(jintervene.mutilate(want.adjacency, jnp.asarray(mask))))
    mean = gt.data.mean(axis=0)
    cov = np.cov(gt.data.T, ddof=0).astype(np.float32)
    nm, nv = intervene.noise_stats(got.adjacency, torch.from_numpy(mean),
                                   torch.from_numpy(cov))
    jnm, jnv = jintervene.noise_stats(want.adjacency, jnp.asarray(mean),
                                      jnp.asarray(cov))
    np.testing.assert_allclose(nm.numpy(), np.asarray(jnm), atol=ATOL)
    np.testing.assert_allclose(nv.numpy(), np.asarray(jnv), atol=ATOL)


@pytest.mark.parametrize("with_moments", [True, False])
def test_interventional_moments_match_reference(with_moments):
    gt, want, got = _fits(5, d=8)
    kw = {}
    if with_moments:
        kw = dict(mean=gt.data.mean(axis=0),
                  cov=np.cov(gt.data.T, ddof=0).astype(np.float32))
    do = {int(want.order[1]): 2.0, int(want.order[5]): -1.0}
    mu, sigma = intervene.interventional_moments(got, do, **kw)
    jmu, jsigma = jintervene.interventional_moments(want, do, **kw)
    np.testing.assert_allclose(mu, np.asarray(jmu), atol=ATOL)
    np.testing.assert_allclose(sigma, np.asarray(jsigma), atol=ATOL)
    j = int(want.order[1])
    assert mu[j] == pytest.approx(2.0, abs=1e-5)
    assert abs(sigma[j, j]) < 1e-6  # pinned: zero variance


@pytest.mark.parametrize("lagged", [False, True])
def test_interventional_from_state_matches_reference(lagged):
    """The reference's moment store carried over into the port's; with
    ``lagged`` a lag-augmented state, whose leading block is sliced."""
    gt, want, got = _fits(6, m=4000, d=6)
    rows = gt.data
    if lagged:
        rows = np.concatenate([rows[1:], rows[:-1]], axis=1)
    jstate = jstats.update_chunk(jstats.init(rows.shape[1]),
                                 jnp.asarray(rows))
    state = stats.MomentState.from_numpy(
        np.asarray(jstate.count), np.asarray(jstate.mean),
        np.asarray(jstate.m2), device="cpu")
    do = {int(want.order[0]): 1.0}
    mu, sigma = intervene.interventional_from_state(got, state, do)
    jmu, jsigma = jintervene.interventional_from_state(want, jstate, do)
    np.testing.assert_allclose(mu, np.asarray(jmu), atol=ATOL)
    np.testing.assert_allclose(sigma, np.asarray(jsigma), atol=ATOL)


def test_bootstrap_effects_match_reference_on_its_indices():
    """The per-resample total effects of the batched bootstrap, and their
    intervals, on the reference's index matrix."""
    gt = simulate_lingam(m=500, d=6, seed=4)
    idx = np.array(jbatched.resample_indices(0, 6, 500))
    _, effs = batched.bootstrap_fits_with(
        torch.from_numpy(np.ascontiguousarray(gt.data)),
        torch.from_numpy(idx).long(), api.FitConfig(compaction="staged"),
        effects._effects_post)
    _, jeffs = jbatched.bootstrap_fits_with(
        gt.data, jnp.asarray(idx), _JCFG, jeffects._effects_post)
    np.testing.assert_allclose(effs.numpy(), np.asarray(jeffs), atol=ATOL)
    ci = effects.effect_ci(effs.numpy(), 0.9)
    jeffs = np.asarray(jeffs)
    np.testing.assert_allclose(ci.mean, jeffs.mean(axis=0), atol=ATOL)
    np.testing.assert_allclose(ci.lo, np.quantile(jeffs, 0.05, axis=0),
                               atol=ATOL)
    np.testing.assert_allclose(ci.hi, np.quantile(jeffs, 0.95, axis=0),
                               atol=ATOL)


def test_bootstrap_effects_equal_the_batched_fits_effects():
    """The intervals come from each resample's own solve (bit for bit on
    any device); a batched solve of the same fits rounds differently on
    the card, so it is held within 1e-6, and every resample against
    float64 ``(I - B)^-1`` within ATOL."""
    gt = simulate_lingam(m=600, d=6, seed=2)
    ci = effects.bootstrap_effects(gt.data, n_sampling=5, seed=1,
                                   device="cpu")
    idx = batched.resample_indices(1, 5, 600, device="cpu")
    fits = batched.bootstrap_fits(
        torch.from_numpy(np.ascontiguousarray(gt.data)), idx,
        api.FitConfig(compaction="staged"))
    each = torch.stack([effects.total_effects(one)
                        for one in fits.unbind()]).numpy()
    want = effects.effect_ci(each, 0.9)
    for field in ("mean", "std", "lo", "hi"):
        np.testing.assert_array_equal(getattr(ci, field),
                                      getattr(want, field))
    np.testing.assert_allclose(each, effects.total_effects(fits).numpy(),
                               atol=1e-6)
    eye = np.eye(6)
    np.testing.assert_allclose(
        each, np.linalg.inv(eye - fits.adjacency.double().numpy()),
        atol=ATOL)
    assert ci.n_sampling == 5 and np.isfinite(ci.mean).all()
    assert ci.covers(ci.mean).all()


def test_bootstrap_effects_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        effects.bootstrap_effects(simulate_lingam(m=200, d=4, seed=0).data,
                                  n_sampling=2)
