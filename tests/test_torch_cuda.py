"""The CUDA kernels against their plain versions, on the card.

Imports neither jax nor the JAX package, so it runs on a machine that
has only PyTorch and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py

Skips without a card. Tolerances: off-diagonal moments within atol 2e-6
(B1), row-tile sums within 2e-6 * m (B2) and fused sums within 4e-6 * m
(B3), the reference's own kernel tolerances; repeat launches
bit-identical, and bit-identical across buffer widths, tile shapes and
the slab-structured launch against per-slab launches.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import fused_stats, ops, pairwise_stats

SHAPES = [(64, 4), (100, 5), (257, 10), (511, 16), (1000, 33), (2048, 64),
          (4096, 130), (777, 40)]
ATOL = 2e-6
# (tile, d, m) straddling the reference's block multiples
# (tests/test_kernels.py _EDGE_CELLS), each at row offset 0 and > 0.
EDGE_CELLS = [(7, 9, 127), (8, 16, 129), (9, 15, 255), (8, 17, 257),
              (16, 16, 128)]
TILES = [(tile, d, m, row0, min(tile, d - row0))
         for tile, d, m in EDGE_CELLS for row0 in (0, max(1, d - tile))]


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


def _standardized(m, d, device):
    x = np.random.default_rng(m * 1000 + d).laplace(size=(m, d))
    xs = ops.standardize(torch.tensor(x, dtype=torch.float32, device=device))
    return xs.contiguous(), ops.correlation(xs).contiguous()


@pytest.mark.gpu
@pytest.mark.parametrize("m,d,width", [(20_000, 100, 75), (20_000, 100, 56),
                                       (3999, 487, 243)])
def test_cuda_kernel_is_width_and_tile_invariant(cuda_device, monkeypatch, m,
                                                 d, width):
    """A pair's moments do not depend on the buffer width nor on the pair
    block the launcher picks: bit for bit."""
    xs, c = _standardized(m, d, cuda_device)
    f1, f2 = pairwise_stats.pairwise_moments(xs, c)
    w1, w2 = pairwise_stats.pairwise_moments(
        xs[:, :width].contiguous(), c[:width, :width].contiguous())
    assert torch.equal(w1, f1[:width, :width])
    assert torch.equal(w2, f2[:width, :width])
    for tile in pairwise_stats.TILES:
        monkeypatch.setattr(pairwise_stats, "tile_for",
                            lambda *a, t=tile, **k: t)
        t1, t2 = pairwise_stats.pairwise_moments(xs, c)
        assert torch.equal(t1, f1) and torch.equal(t2, f2), tile


@pytest.mark.gpu
@pytest.mark.parametrize("m,d,slab", [(2048, 487, 256), (2000, 487, 256),
                                      (333, 10, 128), (777, 40, 96)])
def test_cuda_slab_launch_equals_per_slab_loop(cuda_device, m, d, slab):
    """One slab-structured B2 launch equals the per-slab launches added
    in slab order, bit for bit, ragged last slab included."""
    xs, c = _standardized(m, d, cuda_device)
    before = pairwise_stats.rows_launches
    s1, s2 = pairwise_stats.pairwise_moment_sums_slabs(xs, c, slab)
    torch.cuda.synchronize()
    assert pairwise_stats.rows_launches == before + 1
    t1 = t2 = None
    for k0 in range(0, m, slab):
        u1, u2 = pairwise_stats.pairwise_moment_sums_rows(xs[k0:k0 + slab],
                                                          c, 0, d)
        t1, t2 = (u1, u2) if t1 is None else (t1 + u1, t2 + u2)
    assert torch.equal(s1, t1) and torch.equal(s2, t2)
    before = pairwise_stats.rows_launches
    g1, g2 = ops.pairwise_moment_sums_chunked(xs, c, chunk=slab)
    assert pairwise_stats.rows_launches == before + 1
    assert torch.equal(g1, s1) and torch.equal(g2, s2)
    parts = [pairwise_stats.pairwise_moment_sums_plain(xs[k0:k0 + slab], c)
             for k0 in range(0, m, slab)]
    for n, got in enumerate((s1, s2)):
        want = sum(p[n] for p in parts)
        assert _offdiag_err(got, want, 0) <= 2e-6 * m


@pytest.mark.gpu
def test_cuda_kernel_rejects_what_it_cannot_take(cuda_device):
    xs = torch.zeros(300, 8, device=cuda_device)
    c = torch.rand(8, 8, device=cuda_device)
    with pytest.raises(TypeError):
        pairwise_stats.pairwise_moments(xs.double(), c.double())
    with pytest.raises(ValueError):
        pairwise_stats.pairwise_moments(xs, c.t())  # a column-major view


def _offdiag_err(got, want, row0):
    rows, d = got.shape
    mask = ~torch.eye(rows, d, dtype=torch.bool, device=got.device)
    mask = torch.roll(mask, row0, dims=1) if row0 else mask
    return (got - want)[mask].abs().max().item()


def _raw(m, d, device):
    x = np.random.default_rng(m * 1000 + d).laplace(size=(m, d))
    x = torch.tensor(x, dtype=torch.float32, device=device)
    mu = x.mean(dim=0)
    rstd = torch.rsqrt(((x - mu) ** 2).mean(dim=0))
    c = ops.correlation((x - mu) * rstd).contiguous()
    return x, mu, rstd, c


@pytest.mark.gpu
@pytest.mark.parametrize("tile,d,m,row0,rows", TILES)
def test_cuda_row_tile_kernel_matches_plain_version(cuda_device, tile, d, m,
                                                    row0, rows):
    x, mu, rstd, c = _raw(m, d, cuda_device)
    xs = (x - mu) * rstd
    before = pairwise_stats.rows_launches
    k1, k2 = pairwise_stats.pairwise_moment_sums_rows(xs, c, row0, rows)
    r1, r2 = pairwise_stats.pairwise_moment_sums_rows(xs, c, row0, rows)
    torch.cuda.synchronize()
    assert pairwise_stats.rows_launches == before + 2
    assert torch.equal(k1, r1) and torch.equal(k2, r2)
    p1, p2 = pairwise_stats.pairwise_moment_sums_plain(xs, c, row0=row0,
                                                       rows=rows)
    for got, want in ((k1, p1), (k2, p2)):
        assert got.shape == (rows, d)
        assert _offdiag_err(got, want, row0) <= 2e-6 * m


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tile,d,m,row0,rows", TILES)
def test_cuda_fused_kernel_matches_plain_version(cuda_device, tile, d, m,
                                                 row0, rows, dtype):
    x, mu, rstd, c = _raw(m, d, cuda_device)
    xr = x.to(dtype)
    before = fused_stats.launches
    k1, k2 = fused_stats.fused_moment_sums(xr, mu, rstd, c, row0, rows)
    r1, r2 = fused_stats.fused_moment_sums(xr, mu, rstd, c, row0, rows)
    torch.cuda.synchronize()
    assert fused_stats.launches == before + 2
    assert torch.equal(k1, r1) and torch.equal(k2, r2)
    p1, p2 = fused_stats.fused_moment_sums_plain(xr, mu, rstd, c, row0=row0,
                                                 rows=rows)
    for got, want in ((k1, p1), (k2, p2)):
        assert _offdiag_err(got, want, row0) <= 4e-6 * m
    if dtype == torch.float32:
        # Same standardized values, same summation: B2's sums exactly.
        s1, _ = pairwise_stats.pairwise_moment_sums_rows((x - mu) * rstd, c,
                                                         row0, rows)
        assert torch.equal(k1, s1)


@pytest.mark.gpu
def test_cuda_row_tile_and_fused_kernels_reject_what_they_cannot_take(
        cuda_device):
    x, mu, rstd, c = _raw(300, 8, cuda_device)
    with pytest.raises(ValueError):
        pairwise_stats.pairwise_moment_sums_rows(x, c, 4, 5)  # past d
    with pytest.raises(TypeError):
        pairwise_stats.pairwise_moment_sums_rows(x.double(), c.double(), 0, 8)
    with pytest.raises(TypeError):
        fused_stats.fused_moment_sums(x.half(), mu, rstd, c, 0, 8)
    with pytest.raises(TypeError):
        fused_stats.fused_moment_sums(x, mu.double(), rstd, c, 0, 8)
    with pytest.raises(ValueError):
        fused_stats.fused_moment_sums(x.t(), mu, rstd, c, 0, 8)  # (8, 300)
    with pytest.raises(ValueError):
        fused_stats.fused_moment_sums(x, mu, rstd, c.t(), 0, 8)
