"""Port's moment kernels against the JAX reference, on the same inputs.

The reference runs on the CPU as its own tests run it: the Pallas kernel
in interpret mode, the ``blocked`` backend, tuning off. Inputs are made
with numpy and standardized once by the reference, so both sides see
identical ``x_std`` and ``C``.

Tolerance: off-diagonal moments within atol 2e-6, the reference's own
kernel tolerance (tests/test_kernels.py); the diagonal is undefined and
callers mask it.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import nonlinearity as jnl
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import nonlinearity, ops, pairwise_stats, ref

torch.set_num_threads(1)

SHAPES = [(64, 4), (100, 5), (257, 10), (511, 16), (1000, 33), (2048, 64),
          (4096, 130)]
RAGGED = (777, 40)
ATOL = 2e-6


@functools.lru_cache(maxsize=None)
def _inputs(m, d):
    """(x_std, C) as numpy, standardized by the reference."""
    x = np.random.default_rng(m * 1000 + d).laplace(size=(m, d))
    xs = jops.standardize(jnp.asarray(x, dtype=jnp.float32))
    return np.array(xs), np.array(jops.correlation(xs))


@functools.lru_cache(maxsize=None)
def _pallas(m, d):
    xs, c = _inputs(m, d)
    m1, m2 = jops.pairwise_moments(
        jnp.asarray(xs), jnp.asarray(c), backend="pallas", interpret=True,
        tune_mode="off",
    )
    return np.asarray(m1), np.asarray(m2)


def _offdiag_close(got, want, atol=ATOL):
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else got
    d = got.shape[0]
    mask = ~np.eye(d, dtype=bool)
    np.testing.assert_allclose(got[mask], np.asarray(want)[mask], atol=atol,
                               rtol=0)


def test_nonlinear_terms_match_reference():
    u = np.concatenate([
        np.linspace(-60.0, 60.0, 2001), [0.0, -0.0, 1e-30, 88.0, -88.0],
    ]).astype(np.float32)
    lc, ue = nonlinearity.nonlinear_terms(torch.from_numpy(u))
    jlc, jue = jnl.nonlinear_terms(jnp.asarray(u))
    np.testing.assert_allclose(lc.numpy(), np.asarray(jlc), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(ue.numpy(), np.asarray(jue), rtol=1e-6,
                               atol=1e-7)
    assert np.isfinite(lc.numpy()).all()
    zero = nonlinearity.nonlinear_terms(torch.zeros(3))
    assert all(float(t.abs().max()) == 0.0 for t in zero)


@pytest.mark.parametrize("m,d", SHAPES)
def test_ref_and_blocked_match_reference(m, d):
    xs, c = _inputs(m, d)
    txs, tc = torch.from_numpy(xs), torch.from_numpy(c)
    want_ref = jref.pairwise_moments_ref(jnp.asarray(xs), jnp.asarray(c))
    want_blk = jops.pairwise_moments(jnp.asarray(xs), jnp.asarray(c),
                                     backend="blocked", tune_mode="off")
    for got, want in zip(ref.pairwise_moments_ref(txs, tc), want_ref):
        _offdiag_close(got, want)
    for got, want in zip(ops.pairwise_moments_blocked(txs, tc), want_blk):
        _offdiag_close(got, want)


@pytest.mark.parametrize("m,d", [*SHAPES, RAGGED])
def test_kernel_plain_version_matches_pallas(m, d):
    xs, c = _inputs(m, d)
    got = pairwise_stats.pairwise_moments(torch.from_numpy(xs),
                                          torch.from_numpy(c))
    for g, w in zip(got, _pallas(m, d)):
        assert g.dtype == torch.float32 and g.shape == (d, d)
        _offdiag_close(g, w)


@pytest.mark.parametrize("n_split", [1, 2, 3, 7, 1000])
def test_kernel_plain_version_split_sweep(n_split):
    """Split arithmetic: ragged last split, masked tail past m, clamped
    split counts all give the reference's moments."""
    m, d = RAGGED
    xs, c = _inputs(m, d)
    got = pairwise_stats.pairwise_moments(
        torch.from_numpy(xs), torch.from_numpy(c), n_split=n_split)
    for g, w in zip(got, _pallas(m, d)):
        _offdiag_close(g, w)


def test_kernel_plain_version_row_tile_sums():
    """Row-tile sums (the form the row-tile wrapper will take) are the
    matching rows of the full sums."""
    m, d = RAGGED
    xs, c = (torch.from_numpy(a) for a in _inputs(m, d))
    full1, full2 = pairwise_stats.pairwise_moment_sums_plain(xs, c)
    t1, t2 = pairwise_stats.pairwise_moment_sums_plain(xs, c, row0=16,
                                                       rows=9)
    assert t1.shape == (9, d)
    np.testing.assert_allclose(t1.numpy(), full1[16:25].numpy(), rtol=1e-6)
    np.testing.assert_allclose(t2.numpy(), full2[16:25].numpy(), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize(
    "m,n_split",
    [(1, None), (777, None), (1_000_000, None), (65_164, None), (4096, 7),
     (300, 50), (4095, 31)],
)
def test_split_plan_covers_every_chunk_once(m, n_split):
    n, per = pairwise_stats.split_plan(m, n_split)
    chunks = -(-m // pairwise_stats.ACCUM_CHUNK)
    assert n >= 1 and per >= 1
    assert (n - 1) * per < chunks <= n * per  # no empty split, all covered


def test_split_plan_at_the_main_path_shape():
    # 7813 chunks of 128 samples in 32 splits of 245 (the last ragged).
    assert pairwise_stats.split_plan(1_000_000) == (32, 245)


def test_standardize_and_correlation_match_reference():
    x = np.random.default_rng(3).uniform(size=(500, 6)).astype(np.float32)
    x = x * 3.0 + 100.0
    xs = ops.standardize(torch.from_numpy(x))
    jxs = jops.standardize(jnp.asarray(x))
    np.testing.assert_allclose(xs.numpy(), np.asarray(jxs), atol=2e-5)
    np.testing.assert_allclose(ops.correlation(xs).numpy(),
                               np.asarray(jops.correlation(jxs)), atol=1e-5)


def test_dispatch_backends_and_device_contract():
    xs, c = (torch.from_numpy(a) for a in _inputs(257, 10))
    before = pairwise_stats.launches
    plain = ops.pairwise_moments(xs, c)  # CPU tensor: the plain version
    assert pairwise_stats.launches == before
    s1, _ = pairwise_stats.pairwise_moment_sums_plain(xs, c)
    assert torch.equal(plain[0], s1 * float(np.float32(1.0 / 257)))
    for backend in ("ref", "blocked"):
        for g, w in zip(ops.pairwise_moments(xs, c, backend=backend), plain):
            _offdiag_close(g, w.numpy())
    with pytest.raises(ValueError, match="cuda"):
        ops.pairwise_moments(xs, c, backend="cuda")
    with pytest.raises(ValueError, match="'cuda'"):
        ops.pairwise_moments(xs, c, backend="pallas")
    with pytest.raises(ValueError):
        ops.pairwise_moments(xs, c, backend="nope")


def test_wrapper_rejects_bad_shapes():
    xs = torch.zeros(10, 4)
    with pytest.raises(ValueError):
        pairwise_stats.pairwise_moments(xs, torch.zeros(3, 3))
    with pytest.raises(ValueError):
        pairwise_stats.pairwise_moments(torch.zeros(0, 4), torch.zeros(4, 4))
    with pytest.raises(ValueError):
        pairwise_stats.pairwise_moment_sums_plain(xs, torch.zeros(4, 4),
                                                  row0=2, rows=3)
