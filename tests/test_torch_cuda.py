"""The CUDA kernel against its plain version, on the card.

Imports neither jax nor the JAX package, so it runs on a machine that
has only PyTorch and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py

Skips without a card. Tolerance: off-diagonal moments within atol 2e-6,
the reference's own kernel tolerance; repeat launches bit-identical.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, pairwise_stats

SHAPES = [(64, 4), (100, 5), (257, 10), (511, 16), (1000, 33), (2048, 64),
          (4096, 130), (777, 40)]
ATOL = 2e-6


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("n_split", [None, 1, 3, 7])
@pytest.mark.parametrize("m,d", SHAPES)
def test_cuda_kernel_matches_plain_version(cuda_device, m, d, n_split):
    x = np.random.default_rng(m * 1000 + d).laplace(size=(m, d))
    xs = ops.standardize(torch.tensor(x, dtype=torch.float32,
                                      device=cuda_device))
    c = ops.correlation(xs).contiguous()
    before = pairwise_stats.launches
    k1, k2 = pairwise_stats.pairwise_moments(xs, c, n_split=n_split)
    r1, r2 = pairwise_stats.pairwise_moments(xs, c, n_split=n_split)
    torch.cuda.synchronize()
    assert pairwise_stats.launches == before + 2
    assert torch.equal(k1, r1) and torch.equal(k2, r2)
    assert torch.isfinite(k1).all() and torch.isfinite(k2).all()
    p1, p2 = pairwise_stats.pairwise_moment_sums_plain(xs, c, n_split=n_split)
    inv_m = float(np.float32(1.0 / m))
    mask = ~torch.eye(d, dtype=torch.bool, device=cuda_device)
    for got, want in ((k1, p1 * inv_m), (k2, p2 * inv_m)):
        err = (got - want)[mask].abs().max().item()
        assert err <= ATOL, err


@pytest.mark.gpu
def test_cuda_kernel_rejects_what_it_cannot_take(cuda_device):
    xs = torch.zeros(300, 8, device=cuda_device)
    c = torch.rand(8, 8, device=cuda_device)
    with pytest.raises(TypeError):
        pairwise_stats.pairwise_moments(xs.double(), c.double())
    with pytest.raises(ValueError):
        pairwise_stats.pairwise_moments(xs, c.t())  # a column-major view
