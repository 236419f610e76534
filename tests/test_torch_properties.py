"""Hypothesis property-based tests on the port's invariants, mirroring
tests/test_properties.py (standardization, the entropy bound, scale and
shift invariance of the ordering scores, the correlation matrix, and
sample-permutation invariance of the moments), on the CPU.

``hypothesis`` is optional: the module skips without it, like the
original.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro_torch.core import measures  # noqa: E402
from repro_torch.core.ordering import ordering_scores  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

torch.set_num_threads(1)

_SETTINGS = dict(max_examples=20, deadline=None, derandomize=True)


@given(
    seed=st.integers(0, 2**31 - 1),
    m=st.integers(50, 400),
    d=st.integers(2, 12),
)
@settings(**_SETTINGS)
def test_standardize_moments(seed, m, d):
    rng = np.random.default_rng(seed)
    x = rng.laplace(size=(m, d)).astype(np.float32) * rng.uniform(0.5, 5.0, d)
    xs = ops.standardize(torch.from_numpy(x.astype(np.float32))).numpy()
    np.testing.assert_allclose(xs.mean(axis=0), 0.0, atol=1e-4)
    np.testing.assert_allclose(xs.std(axis=0), 1.0, atol=1e-3)


@given(seed=st.integers(0, 2**31 - 1), m=st.integers(100, 500))
@settings(**_SETTINGS)
def test_entropy_upper_bounded_by_gaussian(seed, m):
    """The max-entropy approximation is H_gauss minus non-negative terms."""
    rng = np.random.default_rng(seed)
    u = rng.laplace(size=m)
    u = (u - u.mean()) / u.std()
    h = float(measures.entropy(torch.tensor(u, dtype=torch.float32)))
    h_gauss = 0.5 * (1.0 + np.log(2 * np.pi))
    assert h <= h_gauss + 1e-6


@given(
    seed=st.integers(0, 2**31 - 1),
    scale=st.floats(0.1, 10.0),
    shift=st.floats(-5.0, 5.0),
)
@settings(**_SETTINGS)
def test_scores_affine_invariant(seed, scale, shift):
    """k_list scores are invariant to positive affine rescaling of columns
    (standardization removes location/scale)."""
    rng = np.random.default_rng(seed)
    x = rng.laplace(size=(300, 6)).astype(np.float32)
    active = torch.ones(6, dtype=torch.bool)
    k1, _, _ = ordering_scores(torch.from_numpy(x), active)
    k2, _, _ = ordering_scores(
        torch.from_numpy((x * scale + shift).astype(np.float32)), active)
    np.testing.assert_allclose(k1.numpy(), k2.numpy(), atol=5e-3)


@given(seed=st.integers(0, 2**31 - 1))
@settings(**_SETTINGS)
def test_correlation_properties(seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((200, 8)).astype(np.float32)
    c = ops.correlation(ops.standardize(torch.from_numpy(x))).numpy()
    np.testing.assert_allclose(c, c.T, atol=1e-5)
    np.testing.assert_allclose(np.diag(c), 1.0, atol=1e-4)
    assert np.all(np.abs(c) <= 1.0 + 1e-4)


@given(seed=st.integers(0, 2**31 - 1), m=st.integers(64, 300),
       d=st.integers(2, 10))
@settings(**_SETTINGS)
def test_pairwise_moments_sample_permutation_invariant(seed, m, d):
    """Moments are means over samples -> invariant to sample shuffling."""
    rng = np.random.default_rng(seed)
    x = rng.laplace(size=(m, d)).astype(np.float32)
    perm = rng.permutation(m)
    xs1 = ops.standardize(torch.from_numpy(x))
    xs2 = ops.standardize(torch.from_numpy(np.ascontiguousarray(x[perm])))
    c1, c2 = ops.correlation(xs1), ops.correlation(xs2)
    m1a, m2a = ops.pairwise_moments(xs1, c1, backend="blocked")
    m1b, m2b = ops.pairwise_moments(xs2, c2, backend="blocked")
    mask = ~torch.eye(d, dtype=torch.bool)
    np.testing.assert_allclose(m1a[mask].numpy(), m1b[mask].numpy(),
                               atol=1e-5)
    np.testing.assert_allclose(m2a[mask].numpy(), m2b[mask].numpy(),
                               atol=1e-5)
