"""The port's rival estimators, VI and small API pieces against the JAX
reference, on the same numpy inputs, on the CPU (``device="cpu"``).

Tolerances, each stated where it is used:

  * the sequential baseline is a copy: orders, adjacency and ``_entropy``
    bit for bit;
  * ``simulate_do`` / ``simulate_gene_perturb`` are copies: bit for bit;
  * entropy and ordering scores: the port sums moments in float64, the
    reference in float32, so within float32 rounding of the moments;
  * NOTEARS and GOLEM pieces from the same W: ``jax.scipy.linalg.expm``
    (Pade with scaling and squaring) and ``torch.linalg.matrix_exp``
    (Taylor) round differently, so h, the losses and their gradients are
    held within a few float32 ulps of their magnitude; fixed-step Adam
    runs from the same start within 1e-5 (GOLEM's log-determinant path:
    5e-5). Whole NOTEARS fits branch on float32 values of h, so they are
    held to the true DAG instead;
  * FastICA from the reference's own starting rows within 1e-4 of the
    unmixing matrix's scale; ICA-LiNGAM to the true DAG (F1 > 0.7, the
    reference's own test);
  * SVGD from the reference's own particles within 1e-5, the kernel
    matrix within 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.baselines import golem as jgolem
from repro.baselines import ica_lingam as jica
from repro.baselines import notears as jnotears
from repro.baselines import sequential_lingam as jseq
from repro.core import measures as jmeasures
from repro.core import ordering as jordering
from repro.data import simulate as jsimulate
from repro.vi import svgd as jsvgd
from repro_torch.baselines import golem, ica_lingam, notears
from repro_torch.baselines import sequential_lingam as seq
from repro_torch.core import fit_direct_lingam, measures, ordering
from repro_torch.data import simulate
from repro_torch.vi import svgd

from benchmarks.torch_equivalence import f1_rec_shd

torch.set_num_threads(1)

EPS32 = float(np.finfo(np.float32).eps)


def _centered(m=500, d=5, seed=0):
    x = jsimulate.simulate_lingam(m=m, d=d, seed=seed).data
    return x - x.mean(axis=0)


def _w0(d=5, seed=0):
    w = (np.random.default_rng(seed).standard_normal((d, d)) * 0.3
         ).astype(np.float32)
    np.fill_diagonal(w, 0.0)
    return w


# -- the sequential baseline and the small API pieces -----------------------

def test_sequential_copy_is_the_original():
    gt = jsimulate.simulate_lingam(m=2000, d=7, seed=0)
    order, b = seq.fit_sequential(gt.data)
    want_order, want_b = jseq.fit_sequential(gt.data)
    np.testing.assert_array_equal(order, want_order)
    np.testing.assert_array_equal(b, want_b)
    u = np.random.default_rng(1).laplace(size=2000)
    assert seq._entropy(u) == jseq._entropy(u)
    assert (seq.K1, seq.K2, seq.GAMMA) == (jseq.K1, jseq.K2, jseq.GAMMA)


def test_entropy_and_diff_mutual_info_match_reference():
    u = np.random.default_rng(2).laplace(size=(4, 3000)).astype(np.float32)
    u = (u - u.mean(axis=1, keepdims=True)) / u.std(axis=1, keepdims=True)
    got = measures.entropy(torch.from_numpy(u)).numpy()
    want = np.asarray(jmeasures.entropy(jnp.asarray(u)))
    # H moves by 2 K1 |m1 - gamma| dm + 2 K2 |m2| dm for moments moved by
    # dm ~ float32 rounding of a 3000-sample mean (~1e-7): well under 1e-5.
    np.testing.assert_allclose(got, want, atol=1e-5)
    h = [float(v) for v in want]
    assert measures.diff_mutual_info(*h) == pytest.approx(
        float(jmeasures.diff_mutual_info(*h)), abs=0.0)


def test_ordering_scores_match_reference():
    gt = jsimulate.simulate_lingam(m=1500, d=6, seed=3)
    active = np.array([True, False, True, True, True, False])
    k, xs, c = ordering.ordering_scores(
        torch.from_numpy(np.ascontiguousarray(gt.data)),
        torch.from_numpy(active))
    jk, jxs, jc = jordering.ordering_scores(
        jnp.asarray(gt.data), jnp.asarray(active), backend="blocked")
    jk = np.asarray(jk)
    # -1e30 at inactive entries (float64 in the port, float32 there).
    np.testing.assert_allclose(k.numpy()[~active], jk[~active], rtol=1e-7)
    # Scores are sums of squared entropy differences; the port's float64
    # moment sums and the reference's float32 ones differ by float32
    # rounding of the moments.
    np.testing.assert_allclose(k.numpy()[active], jk[active], rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(xs.numpy(), np.asarray(jxs), atol=1e-5)
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), atol=1e-5)
    assert int(k.argmax()) == int(jk.argmax())


def test_fit_direct_lingam_is_the_facade():
    gt = jsimulate.simulate_lingam(m=1000, d=5, seed=0)
    model = fit_direct_lingam(gt.data, device="cpu", prune_threshold=0.1)
    np.testing.assert_array_equal(model.causal_order_,
                                  seq.causal_order_sequential(gt.data))


@pytest.mark.parametrize("noise", ["uniform", "laplace"])
def test_simulate_do_is_the_original(noise):
    b = jsimulate.simulate_lingam(m=10, d=6, seed=1).adjacency
    do = {2: 1.5, 4: -0.5}
    np.testing.assert_array_equal(
        simulate.simulate_do(b, do, m=500, noise=noise, seed=3),
        jsimulate.simulate_do(b, do, m=500, noise=noise, seed=3))


def test_simulate_gene_perturb_is_the_original():
    got = simulate.simulate_gene_perturb(m=600, d=30, n_interventions=8,
                                         seed=2)
    want = jsimulate.simulate_gene_perturb(m=600, d=30, n_interventions=8,
                                           seed=2)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


# -- NOTEARS ---------------------------------------------------------------

def test_notears_acyclicity_loss_and_gradient_match_reference():
    x, w0 = _centered(), _w0()
    d = w0.shape[0]
    h = float(notears._h_acyc(torch.from_numpy(w0)))
    jh = float(jnotears._h_acyc(jnp.asarray(w0)))
    # h = tr(e^{W o W}) - d: both round a trace of ~d + h in float32, and
    # the subtraction of d keeps that absolute error.
    assert abs(h - jh) <= 8 * EPS32 * (d + abs(jh))
    args = (0.01, 10.0, 0.5)
    loss = float(notears._loss(torch.from_numpy(w0), torch.from_numpy(x),
                               *args))
    jloss = float(jnotears._loss(jnp.asarray(w0), jnp.asarray(x), *args))
    # The loss carries rho h^2 / 2 + alpha h, so h's error times
    # rho h + alpha on top of float32 rounding.
    assert abs(loss - jloss) <= 8 * EPS32 * (d + abs(jh)) * (
        10.0 * abs(jh) + 0.5) + 1e-6 * abs(jloss)
    g = notears.loss_grad(notears._loss, torch.from_numpy(w0),
                          torch.from_numpy(x), *args).numpy()
    jg = np.asarray(jax.grad(jnotears._loss)(jnp.asarray(w0),
                                             jnp.asarray(x), *args))
    # Two matrix-exponential derivatives in float32: within 1e-4 of the
    # gradient's scale.
    np.testing.assert_allclose(g, jg, atol=1e-4 * np.abs(jg).max())
    # From W = 0 the L1 term's gradient is +lam at every entry, as JAX's.
    zero = np.zeros((d, d), np.float32)
    g0 = notears.loss_grad(notears._loss, torch.from_numpy(zero),
                           torch.from_numpy(x), *args).numpy()
    jg0 = np.asarray(jax.grad(jnotears._loss)(jnp.asarray(zero),
                                              jnp.asarray(x), *args))
    np.testing.assert_allclose(g0, jg0, atol=1e-6)


@pytest.mark.parametrize("start", ["zeros", "w0"])
def test_notears_inner_adam_matches_reference(start):
    x = _centered()
    w0 = np.zeros((5, 5), np.float32) if start == "zeros" else _w0()
    lam, rho, alpha = (0.01, 1.0, 0.0) if start == "zeros" else (
        0.01, 10.0, 0.5)
    got = notears._inner_adam(torch.from_numpy(w0), torch.from_numpy(x),
                              lam, rho, alpha, n_steps=50).numpy()
    want = np.asarray(jnotears._inner_adam(jnp.asarray(w0), jnp.asarray(x),
                                           lam, rho, alpha, n_steps=50))
    # 50 steps of lr 3e-2 from the same W: the gradients' float32
    # differences (above) move W by ~1e-7.
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_notears_bias_corrections_are_float32():
    for i in (0, 1, 9, 99, 299):
        c1, c2 = notears.bias_corrections(i)
        k = np.float32(i + 1.0)
        assert np.float32(c1) == np.float32(1) - np.float32(0.9) ** k
        assert np.float32(c2) == np.float32(1) - np.float32(0.999) ** k


def test_notears_fit_recovers_dag():
    """The outer loop branches on float32 values of h, so whole fits are
    held to the true DAG: F1 >= 0.75 and SHD <= 1 on this DAG (the
    reference's fit scores F1 0.8, SHD 1 here)."""
    gt = jsimulate.simulate_lingam(m=1000, d=6, seed=4)
    b = notears.notears_fit(gt.data, lam=0.001, inner_steps=100,
                            max_outer=8, device="cpu")
    f1, _, shd = f1_rec_shd(b, gt.adjacency)
    assert f1 >= 0.75 and shd <= 1, (f1, shd)
    assert np.all(np.diag(b) == 0.0)


def test_notears_grid_keys():
    x = _centered(m=200, d=3)
    fits = notears.notears_grid(x, lams=(0.01, 0.1), inner_steps=5,
                                max_outer=1, device="cpu")
    assert sorted(fits) == [0.01, 0.1]
    assert all(f.shape == (3, 3) for f in fits.values())


# -- GOLEM -------------------------------------------------------------------

def test_golem_loss_gradient_and_steps_match_reference():
    x, w0 = _centered(), _w0()
    xt = torch.from_numpy(x)
    loss = float(golem._golem_loss(torch.from_numpy(w0), xt, 0.02, 5.0))
    jloss = float(jgolem._golem_loss(jnp.asarray(w0), jnp.asarray(x),
                                     0.02, 5.0))
    # log-likelihood, log-determinant and lam2 h each round in float32.
    assert abs(loss - jloss) <= 1e-5 * max(1.0, abs(jloss))
    g = notears.loss_grad(golem._golem_loss, torch.from_numpy(w0), xt,
                          0.02, 5.0).numpy()
    jg = np.asarray(jax.grad(jgolem._golem_loss)(jnp.asarray(w0),
                                                 jnp.asarray(x), 0.02, 5.0))
    np.testing.assert_allclose(g, jg, atol=1e-4 * np.abs(jg).max())
    got = golem._fit(xt, 0.02, 5.0, 200).numpy()
    want = np.asarray(jgolem._fit_jit(jnp.asarray(x), 0.02, 5.0, 200))
    # 200 steps of lr 1e-2; Adam's normalization magnifies the float32
    # differences of near-zero gradients (measured 5.5e-6).
    np.testing.assert_allclose(got, want, atol=5e-5)


def test_golem_fit_recovers_dag():
    """Held to the true DAG: F1 1 and SHD 0 on this DAG at 1000 steps."""
    gt = jsimulate.simulate_lingam(m=1000, d=6, seed=4)
    b = golem.golem_fit(gt.data, n_steps=1000, device="cpu")
    f1, _, shd = f1_rec_shd(b, gt.adjacency)
    assert (f1, shd) == (1.0, 0)


def test_golem_fit_returns_row_convention():
    gt = jsimulate.simulate_lingam(m=500, d=4, seed=0)
    b = golem.golem_fit(gt.data, n_steps=50, device="cpu")
    want = jgolem.golem_fit(gt.data, n_steps=50)
    np.testing.assert_array_equal(b != 0, want != 0)
    np.testing.assert_allclose(b, want, atol=1e-5)


# -- ICA-LiNGAM --------------------------------------------------------------

def test_whitening_matrix_matches_reference():
    x = jsimulate.simulate_lingam(m=800, d=5, seed=0).data
    z, k = ica_lingam._whiten(torch.from_numpy(x))
    jz, jk = jica._whiten(jnp.asarray(x))
    # V diag(lambda^-1/2) V^T is free of the eigenvectors' signs.
    np.testing.assert_allclose(k.numpy(), np.asarray(jk), atol=1e-5)
    np.testing.assert_allclose(z.numpy(), np.asarray(jz), atol=1e-4)


def test_fastica_from_reference_start_matches_reference():
    x = jsimulate.simulate_lingam(m=500, d=5, seed=0).data
    w_init = np.asarray(jax.random.normal(jax.random.key(0), (5, 5),
                                          jnp.float32))
    got = ica_lingam.fastica(x, n_steps=200, w_init=w_init, device="cpu")
    want = jica.fastica(x, n_steps=200, seed=0)
    # 200 fixed-point steps per row in float32 (measured 1.6e-5 of 3.5).
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max())


def test_ica_lingam_recovers():
    """As the reference's own test (tests/test_core_lingam.py): F1 > 0.7."""
    gt = jsimulate.simulate_lingam(m=8000, d=6, seed=2)
    model = ica_lingam.ICALiNGAM(n_steps=300, prune_threshold=0.1,
                                 device="cpu").fit(gt.data)
    f1, _, shd = f1_rec_shd(model.adjacency_, gt.adjacency)
    assert f1 > 0.7, (f1, shd)


def test_ica_lingam_from_reference_start_matches_reference():
    gt = jsimulate.simulate_lingam(m=2000, d=5, seed=1)
    w_init = np.asarray(jax.random.normal(jax.random.key(0), (5, 5),
                                          jnp.float32))
    model = ica_lingam.ICALiNGAM(n_steps=100, prune_threshold=0.1,
                                 device="cpu").fit(gt.data, w_init=w_init)
    want = jica.ICALiNGAM(n_steps=100, prune_threshold=0.1).fit(gt.data)
    np.testing.assert_array_equal(model.causal_order_, want.causal_order_)
    np.testing.assert_allclose(model.adjacency_, want.adjacency_, atol=1e-5)


def test_ica_helpers_are_the_originals():
    w = np.random.default_rng(5).standard_normal((6, 6))
    np.testing.assert_array_equal(ica_lingam._permute_diag_dominant(w),
                                  jica._permute_diag_dominant(w))
    np.testing.assert_array_equal(ica_lingam._causal_order_from_b(w),
                                  jica._causal_order_from_b(w))


# -- SVGD ---------------------------------------------------------------------

def test_median_of_an_even_count_is_the_midpoint():
    v = np.random.default_rng(6).random(32 * 32).astype(np.float32)
    got = float(svgd._median(torch.from_numpy(v)))
    assert got == float(jnp.median(jnp.asarray(v)))
    s = np.sort(v)
    assert got == float((s[511] + s[512]) * np.float32(0.5))
    assert got != float(torch.median(torch.from_numpy(v)))  # the lower one


def test_rbf_kernel_matches_reference():
    p = np.array(jax.random.normal(jax.random.key(1), (32, 2)))
    k, dk = svgd._rbf(torch.from_numpy(p))
    jk, jdk = jsvgd._rbf(jnp.asarray(p))
    np.testing.assert_allclose(k.numpy(), np.asarray(jk), atol=1e-6)
    np.testing.assert_allclose(dk.numpy(), np.asarray(jdk), atol=1e-5)


def test_svgd_steps_match_reference():
    p = np.array(jax.random.normal(jax.random.key(1), (32, 2)))
    b = np.array([[0.0, 0.0], [0.8, 0.0]], np.float32)
    got = svgd.svgd(torch.from_numpy(p),
                    svgd.gaussian_sem_logp(torch.from_numpy(b), 1.0),
                    n_steps=50).numpy()
    want = np.asarray(jsvgd.svgd(jnp.asarray(p),
                                 jsvgd.gaussian_sem_logp(jnp.asarray(b), 1.0),
                                 n_steps=50))
    # 50 steps of size 1e-2 (measured 1.2e-7 of 2.7).
    np.testing.assert_allclose(got, want, atol=1e-5)


# -- devices ------------------------------------------------------------------

@pytest.mark.parametrize("call", [
    lambda x: notears.notears_fit(x, inner_steps=1, max_outer=1),
    lambda x: golem.golem_fit(x, n_steps=1),
    lambda x: ica_lingam.fastica(x, n_steps=1),
    lambda x: ica_lingam.ICALiNGAM(n_steps=1).fit(x),
])
def test_baselines_raise_without_a_card(call, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.random.default_rng(0).random((50, 3)).astype(np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call(x)
