"""The CUDA kernels against their plain versions, on the card.

Imports neither jax nor the JAX package, so it runs on a machine that
has only PyTorch and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py

Skips without a card. Tolerances: off-diagonal moments within atol 2e-6
(B1), row-tile sums within 2e-6 * m (B2) and fused sums within 4e-6 * m
(B3), the reference's own kernel tolerances; repeat launches
bit-identical, and bit-identical across buffer widths, tile shapes, the
slab-structured launch against per-slab launches, and a batched launch
against the launches on each element; past 512 columns at 4 x 4 (a
block's span staged, not whole rows) bit-identical to the same launch
made to stage whole rows. Every pair-block candidate of the
dispatcher's search gives the heuristic plan's sums bit for bit. The
bootstrap's two strategies on the card: equal edge probabilities,
coefficients within 1e-5. Total effects and impulse responses on the card
against float64 numpy, within 1e-5. A small serving round trip on the
card: batched fits with the single fits' orders and adjacency within
1e-5, one B2 launch per ordering step of a batched flush, the injected
drift alert delivered once, and effect answers within 1e-5 of the direct
call. The paper's rival estimators on the card held to their DAGs as on
the CPU (GOLEM's steps within 1e-4 of the CPU's), SVGD within 1e-5 of
the CPU's, one speed-up row with one B1 launch per step, RCA past one
slab within 1e-5 of the CPU's, a NaN post refused, and B3 timed through
the autotuner's runner (its sums a direct launch's bit for bit). The
port's spans on the profiler's clock: a traced fit's exported starts and
durations within 1 ms of their mirrored ranges. The ordering step's
column-pass kernels against the composed passes (tolerances on each
test), bit-identical across buffer widths and batch sizes, and the staged
order equal to the masked one through them; the ordering compacted at
every step against the masked scan at full width, bit for bit, and its
``order.pair_terms`` count. The step's score-and-root kernel against the
composed ``step_scores`` and ``torch.argmax``: the same root, the scores
within float64 rounding (bit for bit where a row has one term), tied
maxima to the first, an element's bits the same alone as in a batch, and
the card's ordering the composed path's order.
"""

import os

import numpy as np
import pytest
import torch

from repro_torch.core import api, bootstrap
from repro_torch.data.simulate import (simulate_lingam, simulate_var_breaks,
                                       simulate_var_stocks)
from repro_torch.infer import effects, query
from repro_torch.kernels import fused_stats, ops, pairwise_stats
from repro_torch.kernels.tune import autotune, cache, registry

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


# B1 across the staging boundary at 8,192 rows: up to 512 columns a 4 x 4
# launch stages whole rows, past that each block's span; 513, 601, 1,027
# and 2,047 leave d % 4 != 0, and every width past 512 wraps some spans
# into the next row block.
SPAN_WIDTHS = (512, 513, 601, 964, 1027, 2047)


@pytest.fixture(scope="module")
def wide_input():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return _standardized(8192, 2048, torch.device("cuda", 0))


def _pinned(op, tile):
    return registry.Plan(op, "cuda-pair-tile", "cuda", tile=tile)


def _whole_rows(monkeypatch):
    """Make every launch stage whole sample rows, at any width."""
    monkeypatch.setattr(pairwise_stats, "staged_columns",
                        lambda d, tile: ("rows", -(-d // 4) * 4))


@pytest.mark.gpu
@pytest.mark.parametrize("tile", pairwise_stats.TILES)
def test_cuda_span_staging_equals_whole_rows(wide_input, monkeypatch, tile):
    """Each T forced: B1 on the leading columns of an (8,192, 2,048) input
    gives the full launch's top-left block, at widths on both sides of
    the staging boundary, and the same bits as a launch that stages
    whole rows."""
    xs, c = wide_input
    plan = _pinned("pairwise_moments", tile)
    f1, f2 = pairwise_stats.pairwise_moments(xs, c, plan=plan)
    for w in (*SPAN_WIDTHS, 2048):
        xw, cw = xs[:, :w].contiguous(), c[:w, :w].contiguous()
        g1, g2 = pairwise_stats.pairwise_moments(xw, cw, plan=plan)
        assert torch.equal(g1, f1[:w, :w]) and torch.equal(g2, f2[:w, :w]), w
        with monkeypatch.context() as mp:
            _whole_rows(mp)
            r1, r2 = pairwise_stats.pairwise_moments(xw, cw, plan=plan)
        assert torch.equal(g1, r1) and torch.equal(g2, r2), w


@pytest.mark.gpu
def test_cuda_span_staging_in_a_batch(wide_input, monkeypatch):
    """A batch of 2 at width 1,027 (the leading and the trailing 1,027
    columns): each element the full launch's block and its own launch's
    bits, spans or whole rows."""
    xs, c = wide_input
    w = 1027
    xb = torch.stack([xs[:, :w], xs[:, -w:]]).contiguous()
    cb = torch.stack([c[:w, :w], c[-w:, -w:]]).contiguous()
    f1, f2 = pairwise_stats.pairwise_moments(xs, c)
    g1, g2 = pairwise_stats.pairwise_moments(xb, cb)
    assert torch.equal(g1[0], f1[:w, :w]) and torch.equal(g2[0], f2[:w, :w])
    assert torch.equal(g1[1], f1[-w:, -w:]) and torch.equal(g2[1],
                                                            f2[-w:, -w:])
    for k in range(2):
        s1, s2 = pairwise_stats.pairwise_moments(xb[k], cb[k])
        assert torch.equal(g1[k], s1) and torch.equal(g2[k], s2), k
    _whole_rows(monkeypatch)
    r1, r2 = pairwise_stats.pairwise_moments(xb, cb)
    assert torch.equal(g1, r1) and torch.equal(g2, r2)


@pytest.mark.gpu
@pytest.mark.parametrize("tile", pairwise_stats.TILES)
def test_cuda_span_staging_of_row_tiles(wide_input, monkeypatch, tile):
    """B2 row tiles past row 0 at d = 1,027 (a tile of 300 rows and a
    ragged one of 7 at the end): the full width's rows, and the bits of a
    launch that stages whole rows."""
    xs, c = wide_input
    w = 1027
    xw, cw = xs[:, :w].contiguous(), c[:w, :w].contiguous()
    plan = _pinned("pairwise_moment_sums_rows", tile)
    for row0, rows in ((100, 300), (1020, 7)):
        g1, g2 = pairwise_stats.pairwise_moment_sums_rows(xw, cw, row0, rows,
                                                          plan=plan)
        f1, f2 = pairwise_stats.pairwise_moment_sums_rows(xs, c, row0, rows,
                                                          plan=plan)
        assert torch.equal(g1, f1[:, :w]) and torch.equal(g2, f2[:, :w])
        with monkeypatch.context() as mp:
            _whole_rows(mp)
            r1, r2 = pairwise_stats.pairwise_moment_sums_rows(
                xw, cw, row0, rows, plan=plan)
        assert torch.equal(g1, r1) and torch.equal(g2, r2), (row0, rows)


@pytest.mark.gpu
def test_cuda_span_staging_over_slabs(wide_input, monkeypatch):
    """B2 over 256-row slabs at d = 600: the per-slab launches added in
    order, and the bits of a launch that stages whole rows."""
    xs, c = wide_input
    w, slab = 600, 256
    xw, cw = xs[:, :w].contiguous(), c[:w, :w].contiguous()
    plan = _pinned("pairwise_moment_sums_chunked", 4)
    assert pairwise_stats.staged_columns(w, 4)[0] == "span"
    s1, s2 = pairwise_stats.pairwise_moment_sums_slabs(xw, cw, slab,
                                                       plan=plan)
    t1 = t2 = None
    for k0 in range(0, xw.shape[0], slab):
        u1, u2 = pairwise_stats.pairwise_moment_sums_rows(
            xw[k0:k0 + slab], cw, 0, w,
            plan=_pinned("pairwise_moment_sums_rows", 4))
        t1, t2 = (u1, u2) if t1 is None else (t1 + u1, t2 + u2)
    assert torch.equal(s1, t1) and torch.equal(s2, t2)
    _whole_rows(monkeypatch)
    r1, r2 = pairwise_stats.pairwise_moment_sums_slabs(xw, cw, slab,
                                                       plan=plan)
    assert torch.equal(s1, r1) and torch.equal(s2, r2)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [601, 1027])
def test_cuda_span_staging_matches_plain_version(cuda_device, d):
    """Widths that stage spans against the plain version, atol 2e-6."""
    xs, c = _standardized(1000, d, cuda_device)
    assert pairwise_stats.staged_columns(d, 4)[0] == "span"
    k1, k2 = pairwise_stats.pairwise_moments(xs, c)
    p1, p2 = pairwise_stats.pairwise_moment_sums_plain(xs, c)
    inv_m = float(np.float32(1.0 / 1000))
    mask = ~torch.eye(d, dtype=torch.bool, device=cuda_device)
    for got, want in ((k1, p1 * inv_m), (k2, p2 * inv_m)):
        assert (got - want)[mask].abs().max().item() <= ATOL


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


def _standardized_batch(b, m, d, device):
    rng = np.random.default_rng(b * 7 + m * 1000 + d)
    xs = torch.stack([ops.standardize(torch.tensor(
        rng.laplace(size=(m, d)), dtype=torch.float32, device=device))
        for _ in range(b)])
    return xs.contiguous(), torch.stack(
        [ops.correlation(x) for x in xs]).contiguous()


@pytest.mark.gpu
@pytest.mark.parametrize("b,m,d", [(4, 4000, 487), (4, 4000, 243),
                                   (3, 3999, 487), (5, 777, 40)])
def test_cuda_batched_launch_equals_per_element_launches(cuda_device, b, m,
                                                         d):
    """One B1 launch over a batch gives each element the sums of the
    launch on that element alone, bit for bit (the launcher may pick
    another pair block for the batch: T does not change a pair's sums);
    and agrees with the batched plain version."""
    xs, cs = _standardized_batch(b, m, d, cuda_device)
    before = pairwise_stats.launches
    g1, g2 = pairwise_stats.pairwise_moments(xs, cs)
    torch.cuda.synchronize()
    assert pairwise_stats.launches == before + 1
    assert g1.shape == (b, d, d)
    for k in range(b):
        s1, s2 = pairwise_stats.pairwise_moments(xs[k], cs[k])
        assert torch.equal(g1[k], s1) and torch.equal(g2[k], s2), k
    if m * d <= 40_000:
        p1, p2 = pairwise_stats.pairwise_moment_sums_plain(xs, cs)
        inv_m = float(np.float32(1.0 / m))
        mask = ~torch.eye(d, dtype=torch.bool, device=cuda_device)
        for got, want in ((g1, p1 * inv_m), (g2, p2 * inv_m)):
            assert (got - want)[:, mask].abs().max().item() <= ATOL


@pytest.mark.gpu
@pytest.mark.parametrize("b,m,d,slab", [(2, 2048, 487, 256),
                                        (3, 2000, 40, 96)])
def test_cuda_batched_slab_launch_equals_per_element(cuda_device, b, m, d,
                                                     slab):
    xs, cs = _standardized_batch(b, m, d, cuda_device)
    before = pairwise_stats.rows_launches
    g1, g2 = ops.pairwise_moment_sums_chunked(xs, cs, chunk=slab)
    torch.cuda.synchronize()
    assert pairwise_stats.rows_launches == before + 1
    for k in range(b):
        s1, s2 = pairwise_stats.pairwise_moment_sums_slabs(xs[k], cs[k], slab)
        assert torch.equal(g1[k], s1) and torch.equal(g2[k], s2), k
    r1, _ = pairwise_stats.pairwise_moment_sums_rows(xs, cs, 3, d - 5)
    for k in range(b):
        t1, _ = pairwise_stats.pairwise_moment_sums_rows(xs[k], cs[k], 3,
                                                         d - 5)
        assert torch.equal(r1[k], t1)


@pytest.mark.gpu
@pytest.mark.parametrize("compaction", ["none", "staged"])
def test_cuda_bootstrap_vmap_equals_loop(cuda_device, compaction):
    gt = simulate_lingam(m=500, d=6, seed=4)
    kw = dict(n_sampling=6, threshold=0.1, seed=0,
              config=api.FitConfig(compaction=compaction))
    before = pairwise_stats.launches
    res_v = bootstrap.bootstrap_lingam(gt.data, strategy="vmap", **kw)
    # one per ordering step; the last column needs none
    assert pairwise_stats.launches == before + 5
    res_l = bootstrap.bootstrap_lingam(gt.data, strategy="loop", **kw)
    assert pairwise_stats.launches == before + 5 + 6 * 5
    np.testing.assert_array_equal(res_v.edge_prob, res_l.edge_prob)
    np.testing.assert_allclose(res_v.coef_mean, res_l.coef_mean, atol=1e-5)
    np.testing.assert_allclose(res_v.coef_std, res_l.coef_std, atol=1e-5)


@pytest.mark.gpu
def test_cuda_effects_and_impulse_responses_match_float64(cuda_device):
    """The facade's numpy outputs go to the card by default."""
    rng = np.random.default_rng(0)
    d, k, horizon = 64, 2, 4
    perm = rng.permutation(d)
    b0 = np.zeros((d, d), np.float32)
    b0[np.ix_(perm, perm)] = np.tril(rng.normal(size=(d, d)) * 0.1, k=-1)
    mats = (rng.normal(size=(k, d, d)) * 0.02).astype(np.float32)
    irf = effects.var_irf(b0, perm, mats, horizon)
    assert irf.is_cuda
    a0 = np.linalg.inv(np.eye(d) - b0.astype(np.float64))
    phis = [np.eye(d)]
    for h in range(1, horizon + 1):
        phis.append(sum(mats[t].astype(np.float64) @ phis[h - 1 - t]
                        for t in range(min(h, k))))
    np.testing.assert_allclose(irf.cpu().numpy(), np.stack(phis) @ a0,
                               atol=1e-5)
    t = effects.total_effects_impl(torch.from_numpy(b0).to(cuda_device),
                                   torch.from_numpy(perm).to(cuda_device))
    np.testing.assert_allclose(t.cpu().numpy(), a0, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("op,b,m,d,chunk", [
    ("pairwise_moments", 1, 4000, 487, None),
    ("pairwise_moments", 1, 3999, 487, None),
    ("pairwise_moments", 4, 4000, 487, None),
    ("pairwise_moments", 1, 20_000, 24, None),
    ("pairwise_moment_sums_chunked", 1, 2048, 487, 256),
    ("pairwise_moment_sums_chunked", 8, 2048, 487, 256),
    ("pairwise_moment_sums_rows", 1, 2000, 40, None),
])
def test_cuda_every_tile_candidate_is_bit_equal(cuda_device, op, b, m, d,
                                                chunk):
    """The autotuner's candidates (every pair-block edge) give the
    heuristic plan's sums bit for bit, in one launch each."""
    if b == 1:
        x = ops.standardize(torch.tensor(
            np.random.default_rng(m + d).laplace(size=(m, d)),
            dtype=torch.float32, device=cuda_device))
        c = ops.correlation(x).contiguous()
    else:
        x, c = _standardized_batch(b, m, d, cuda_device)
    shape = (d - 3, d, m) if op == "pairwise_moment_sums_rows" else (m, d)
    run = {
        "pairwise_moments": lambda p: ops.pairwise_moments(x, c, plan=p),
        "pairwise_moment_sums_chunked": lambda p: (
            ops.pairwise_moment_sums_chunked(x, c, chunk=chunk, plan=p)),
        "pairwise_moment_sums_rows": lambda p: (
            ops.pairwise_moment_sums_rows(x, c, 0, d - 3, plan=p)),
    }[op]
    cands = autotune.candidate_plans(op, shape, chunk=chunk, batch=b)
    assert sorted(p.tile for p in cands) == sorted(pairwise_stats.TILES)
    want = run(cands[0])
    for p in cands[1:]:
        before = pairwise_stats.launches + pairwise_stats.rows_launches
        got = run(p)
        torch.cuda.synchronize()
        assert pairwise_stats.launches + pairwise_stats.rows_launches == (
            before + 1)
        assert all(torch.equal(g, w) for g, w in zip(got, want)), p


@pytest.mark.gpu
def test_cuda_dispatch_keys_the_card_and_records_a_search(cuda_device,
                                                          tmp_path):
    name = torch.cuda.get_device_name(cuda_device)
    assert registry.device_kind(cuda_device) == name
    table = cache.TuneTable(default_path=os.devnull,
                            overlay_path_=str(tmp_path / "t.json"))
    miss = registry.dispatch("pairwise_moments", (4000, 487), table=table)
    assert miss == registry.dispatch_heuristic("pairwise_moments",
                                               (4000, 487))
    tuned = autotune.autotune_op("pairwise_moments", (4000, 487),
                                 table=table, repeats=2)
    assert tuned.key.split("/")[1] == "-".join(name.lower().split())
    assert all(m.seconds > 0 for m in tuned.measurements)
    hit = registry.dispatch("pairwise_moments", (4000, 487), table=table)
    assert hit == tuned.best and hit.tile in pairwise_stats.TILES


@pytest.mark.gpu
def test_cuda_autotune_times_b3_through_its_runner(cuda_device, tmp_path):
    """The autotuner's B3 runner launches the fused kernel: its one plan
    is timed, and the sums it timed are a direct launch's bit for bit and
    within 4e-6 a sample of the plain version."""
    shape = (8, 64, 1024)
    table = cache.TuneTable(default_path=os.devnull,
                            overlay_path_=str(tmp_path / "t.json"))
    before = fused_stats.launches
    tuned = autotune.autotune_op("fused_moment_sums", shape, table=table,
                                 repeats=2)
    assert fused_stats.launches > before
    assert tuned.best.variant == "cuda-fused"
    assert len(tuned.measurements) == 1 and tuned.measurements[0].seconds > 0
    timed = autotune._bench_fn("fused_moment_sums", shape, None, 1,
                               cuda_device)(tuned.best)
    x_raw, mu, rstd, c = autotune.fused_bench_inputs(shape, cuda_device)
    direct = ops.fused_moment_rows(x_raw, mu, rstd, c, 0, shape[0])
    plain = fused_stats.fused_moment_sums_plain(x_raw, mu, rstd, c, row0=0,
                                                rows=shape[0])
    off = ~torch.eye(shape[0], shape[1], dtype=torch.bool,
                     device=cuda_device)
    for a, b, p in zip(timed, direct, plain):
        assert torch.equal(a, b)
        assert float((a - p)[off].abs().max()) <= 4e-6 * shape[2]


@pytest.mark.gpu
def test_cuda_bootstrap_auto_models_the_ports_memory(cuda_device):
    """On the card "auto" compares the port's own peak model with the
    free memory: a budget below the model sends it to the loop."""
    gt = simulate_lingam(m=300, d=5, seed=2)
    need = bootstrap.vmap_peak_bytes(3, 300, 5)
    kw = dict(n_sampling=3, threshold=0.1, seed=0)
    before = pairwise_stats.launches
    bootstrap.bootstrap_lingam(gt.data, max_vmap_bytes=need, **kw)
    assert pairwise_stats.launches == before + 4  # vmap: one per step
    bootstrap.bootstrap_lingam(gt.data, max_vmap_bytes=need - 1, **kw)
    assert pairwise_stats.launches == before + 4 + 3 * 4  # the loop
    bootstrap.bootstrap_lingam(gt.data, **kw)  # the card's free memory
    assert pairwise_stats.launches == before + 4 + 12 + 4


@pytest.mark.gpu
def test_cuda_engine_round_trip(cuda_device):
    from repro_torch.serve.engine import CausalDiscoveryEngine, FitRequest
    from repro_torch.stream import MonitorConfig, StreamConfig

    eng = CausalDiscoveryEngine(api.FitConfig(compaction="staged"),
                                batch_size=4)
    reqs = [FitRequest(data=simulate_lingam(m=2000, d=7, seed=s).data)
            for s in range(3)]
    before = pairwise_stats.launches
    eng.run(reqs)
    assert pairwise_stats.launches == before + 6  # one batched fit
    for r in reqs:
        one = api.fit_fn(torch.as_tensor(np.ascontiguousarray(r.data),
                                         device=cuda_device),
                         api.FitConfig(compaction="staged"))
        np.testing.assert_array_equal(one.order.cpu().numpy(),
                                      r.result.order)
        np.testing.assert_allclose(one.adjacency.cpu().numpy(),
                                   r.result.adjacency, atol=1e-5)
    d, chunk, wc = 12, 100, 8
    br = simulate_var_breaks(m=1400, d=d, kind="noise_scale", seed=0,
                             at=1000)
    peer = simulate_var_stocks(m=1400, d=d, seed=9)[0]
    cfg = StreamConfig(d=d, chunk=chunk, window_chunks=wc,
                       monitor=MonitorConfig())
    sids = [eng.open_stream(cfg) for _ in range(2)]
    flushes = []
    for k in range(14):
        for sid, x in zip(sids, (br.series, peer)):
            b2 = pairwise_stats.rows_launches
            out = eng.post_chunk(sid, x[k * chunk:(k + 1) * chunk])
            if out:
                flushes.append((len(out), pairwise_stats.rows_launches - b2))
    # One B2 launch per ordering step (d - 1: the last column needs none)
    # for each batched refit: a flush whose windows differ in length (one
    # has slid, one has not) holds two.
    assert flushes and all(n % (d - 1) == 0 for _, n in flushes)
    assert (2, d - 1) in flushes
    alerts = eng.poll_alerts()
    assert br.variable in {a.variable for a in alerts
                           if a.sid == sids[0]}
    assert eng.poll_alerts() == []
    qs = eng.query([query.EffectQuery(graph=sids[1]),
                    query.EffectQuery(graph=reqs[0].result)])
    np.testing.assert_allclose(qs[0].effects, effects.total_effects(
        eng.stream_session(sids[1]).last_fit.result).cpu().numpy(),
        atol=1e-5)
    assert qs[1].graph.device.type == "cuda"


def _f1(b_est, b_true, thresh=0.1):
    e, t = np.abs(b_est) > thresh, b_true != 0
    tp, fp, fn = np.sum(e & t), np.sum(e & ~t), np.sum(~e & t)
    prec, rec = tp / max(tp + fp, 1), tp / max(tp + fn, 1)
    return 2 * prec * rec / max(prec + rec, 1e-12), fp + fn


@pytest.mark.gpu
def test_cuda_baselines_recover_their_dags(cuda_device):
    """The rival estimators on the card, held to the true DAG as their CPU
    tests are: NOTEARS F1 >= 0.75 and SHD <= 1 on the CPU test's DAG,
    GOLEM F1 1 and SHD 0 (as on the CPU), ICA-LiNGAM F1 > 0.7. Adam steps
    on near-zero gradients take the sign of their float32 rounding, so
    the card's and the CPU's iterates part by ~1e-2 on some entries; the
    fits are compared through the DAG."""
    from repro_torch.baselines import golem, ica_lingam, notears

    gt = simulate_lingam(m=1000, d=6, seed=4)
    b = notears.notears_fit(gt.data, lam=0.001, inner_steps=100,
                            max_outer=8)
    f1, shd = _f1(b, gt.adjacency)
    assert f1 >= 0.75 and shd <= 1, (f1, shd)
    assert _f1(golem.golem_fit(gt.data, n_steps=1000), gt.adjacency) == (
        1.0, 0)
    gt = simulate_lingam(m=8000, d=6, seed=2)
    model = ica_lingam.ICALiNGAM(n_steps=300, prune_threshold=0.1).fit(
        gt.data)
    assert _f1(model.adjacency_, gt.adjacency)[0] > 0.7


@pytest.mark.gpu
def test_cuda_svgd_matches_cpu(cuda_device):
    from repro_torch.vi import svgd

    p = np.random.default_rng(0).standard_normal((32, 2)).astype(np.float32)
    b = torch.tensor([[0.0, 0.0], [0.8, 0.0]])
    got = svgd.svgd(torch.tensor(p, device=cuda_device),
                    svgd.gaussian_sem_logp(b.to(cuda_device), 1.0),
                    n_steps=50)
    want = svgd.svgd(torch.tensor(p), svgd.gaussian_sem_logp(b, 1.0),
                     n_steps=50)
    assert got.is_cuda
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=1e-5)


@pytest.mark.gpu
def test_cuda_speedup_row_orders_agree(cuda_device):
    """One shape of the speed-up grid on the card: one B1 launch per
    ordering step (d - 1 steps), orders equal to the sequential loop's or
    parting only at a tie (the row raises otherwise)."""
    from benchmarks import torch_speedup

    row = torch_speedup.shape_row(1000, 8, cuda_device, reps=1)
    assert row["b1_launches_per_ordering"] == 7
    assert row["kernel_ordering_s"] > 0.0 and row["speedup"] > 0.0


@pytest.mark.gpu
def test_cuda_rca_slabs_and_non_finite_posts(cuda_device):
    """RCA past one 512-row slab on the card equals the CPU's answers; a
    NaN post is refused on the card as on the CPU."""
    from repro_torch.infer import rca
    from repro_torch.stream import window

    gt = simulate_lingam(m=4000, d=6, seed=8)
    res = api.fit_fn(torch.tensor(np.ascontiguousarray(gt.data)))
    on_card = api.FitResult(*(t.to(cuda_device) for t in (
        res.order, res.adjacency, res.resid_var)))
    mean = gt.data.mean(axis=0)
    got = rca.attribute(on_card, gt.data[:1300], mean=mean, target=2)
    want = rca.attribute(res, gt.data[:1300], mean=mean, target=2)
    np.testing.assert_allclose(got.scores, want.scores, rtol=1e-5,
                               atol=1e-5)
    roll = window.RollingVarLiNGAM(4, 32, 3, device=cuda_device)
    rows = np.zeros((32, 4), np.float32)
    rows[3, 1] = np.nan
    with pytest.raises(ValueError, match="non-finite"):
        roll.push(rows)
    assert roll.n_pushed == 0


def _clock_gaps(doc, events):
    """Largest |start| and |duration| differences (ns) between the spans
    of ``to_chrome_trace`` and their mirrored ``record_function`` ranges
    (host events of the same name, matched in start order), and how many
    were matched."""
    base = doc["baseTimeNanoseconds"]
    spans, ranges = {}, {}
    for e in doc["traceEvents"]:
        spans.setdefault(e["name"], []).append(
            (base + e["ts"] * 1e3, e["dur"] * 1e3))
    for e in events:
        if e.name() in spans and "CUDA" not in str(e.device_type()):
            ranges.setdefault(e.name(), []).append(
                (e.start_ns(), e.duration_ns()))
    start_gap = dur_gap = 0.0
    n = 0
    for name, got in spans.items():
        want = sorted(ranges.get(name, []))
        assert len(want) == len(got), name
        for (s0, d0), (s1, d1) in zip(sorted(got), want):
            start_gap = max(start_gap, abs(s0 - s1))
            dur_gap = max(dur_gap, abs(d0 - d1))
            n += 1
    return start_gap, dur_gap, n


@pytest.mark.gpu
def test_cuda_spans_lie_on_the_profilers_clock(cuda_device):
    """One staged fit on the card under ``torch.profiler``, spans mirrored,
    in a window that opens with a range of its own (as a traced run's):
    every span's exported start (``baseTimeNanoseconds + ts``) lies within
    1 ms of its range's, durations within 1 ms, and each
    ``kernels.moments`` span names the launch's pair-block edge."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch import obs
    from repro_torch.obs import trace

    gt = simulate_lingam(m=4000, d=16, seed=3)
    x = torch.as_tensor(np.ascontiguousarray(gt.data, np.float32),
                        device=cuda_device)
    cfg = api.FitConfig(compaction="staged")
    api.fit_fn(x, cfg)
    torch.cuda.synchronize()
    obs.reset()
    obs.enable()
    trace.set_annotation_hook(record_function)
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof, \
                record_function("clock.window"):
            api.fit_fn(x, cfg)
            torch.cuda.synchronize()
        doc = obs.to_chrome_trace()
        moments = [s for r in obs.roots() for s in r.children[0].children
                   if s.name == "kernels.moments"]
    finally:
        trace.set_annotation_hook(None)
        obs.disable()
        obs.reset()
    start_gap, dur_gap, n = _clock_gaps(doc,
                                        prof.profiler.kineto_results.events())
    assert n == len(doc["traceEvents"]) > 16
    assert start_gap < 1e6 and dur_gap < 1e6, (start_gap, dur_gap)
    assert len(moments) == 15  # a step per width 16 .. 2
    assert all(s.attrs["tile"] in pairwise_stats.TILES for s in moments)


# ---------------------------------------------------------------------------
# the ordering step's column passes (kernels/step_passes.py)
# ---------------------------------------------------------------------------

# (b, m, w): unbatched and batched buffers, widths off the 64-column Gram
# tile and the 128-column block, sample counts off the 32-sample slab; the
# gene screen's width, 964.
STEP_SHAPES = [(None, 1000, 7), (None, 4097, 130), (None, 3999, 487),
               (3, 2048, 65), (2, 333, 64), (None, 8192, 964)]


def _step_data(b, m, w, seed=0, device="cuda"):
    rng = np.random.default_rng(seed)
    shape = (m, w) if b is None else (b, m, w)
    # Skewed non-Gaussian columns with means well away from 0.
    x = rng.exponential(size=shape) * rng.uniform(0.5, 3.0, size=shape[-1])
    x = x + rng.uniform(-20.0, 20.0, size=shape[-1])
    return torch.tensor(x, dtype=torch.float32, device=device)


@pytest.mark.gpu
@pytest.mark.parametrize("b,m,w", STEP_SHAPES)
def test_cuda_step_standardize_matches_composed(cuda_device, b, m, w):
    """The kernels' standardization, correlation and column moments against
    the composed passes on the card: means and variances within 3e-7 and
    5e-7 relative (both float64 sums rounded to float32, a last-bit
    difference), x_std within 2e-5 absolute (a last bit of the mean times
    rstd), C within 2e-6, the column moments of the kernels' own x_std
    within 2e-6 (B1's MUFU integrand against torch's), and the
    float64 Gram means within 1e-12 of a float64 product of the kernels'
    own x_std."""
    from repro_torch.core import measures, ordering
    from repro_torch.kernels import step_passes

    x = _step_data(b, m, w, seed=m + w)
    before = step_passes.launches
    x_std, c, mu, var, (cm1, cm2), gram = step_passes.standardize(x)
    torch.cuda.synchronize()
    assert step_passes.launches == before + 1
    want = ordering.step_standardize(x, ordering.LocalReducer())
    torch.testing.assert_close(mu, want[2], rtol=3e-7, atol=0)
    torch.testing.assert_close(var, want[3], rtol=5e-7, atol=0)
    torch.testing.assert_close(x_std, want[0], rtol=0, atol=2e-5)
    torch.testing.assert_close(c, want[1], rtol=0, atol=2e-6)
    wm1, wm2 = measures.nonlinear_moments(x_std, axis=-2)
    torch.testing.assert_close(cm1, wm1, rtol=0, atol=2e-6)
    torch.testing.assert_close(cm2, wm2, rtol=0, atol=2e-6)
    xd = x_std.double()
    torch.testing.assert_close(gram, xd.mT @ xd / m, rtol=0, atol=1e-12)
    assert torch.equal(c, gram.float())
    assert torch.equal(gram, gram.mT)


@pytest.mark.gpu
@pytest.mark.parametrize("b,m,w", STEP_SHAPES)
@pytest.mark.parametrize("where", ["first", "last", "padded"])
def test_cuda_step_residualize_matches_composed(cuda_device, b, m, w, where):
    """The kernels' compacting residual update against the composed one
    (``ordering.compact_residualize``): the root at the first column, the
    last real one, or a zero padding column, with two padding columns.
    Updated columns within 2e-5 relative of the buffer's scale (the
    coefficient from the float64 Gram means against the composed float32
    covariance), in the same places; the surviving labels, and the root's
    label at its position of the order, the composed ones; the padding
    columns left zero."""
    from repro_torch.core import ordering
    from repro_torch.kernels import step_passes

    x = _step_data(b, m, w, seed=7 * m + w)
    lead = x.shape[:-2]
    x = torch.nn.functional.pad(x, (0, 2))  # two padding columns
    width = w + 2
    labels = (3 * torch.arange(width, device=cuda_device) + 1).expand(
        *lead, width).contiguous()
    col = {"first": 0, "last": w - 1, "padded": w + 1}[where]
    root = torch.full(lead, col, dtype=torch.int64, device=cuda_device)
    st = ordering.LocalReducer().standardize(x)
    order = torch.full((*lead, width + 1), -1, dtype=torch.int64,
                       device=cuda_device)
    before = step_passes.residualize_launches
    got, got_labels = step_passes.residualize(x, root, st.gram, st.var,
                                              labels, order, 1)
    torch.cuda.synchronize()
    assert step_passes.residualize_launches == before + 1
    mu, var = ordering.step_standardize(x, ordering.LocalReducer())[2:]
    want_order = torch.full_like(order, -1)
    want, want_labels = ordering.compact_residualize(
        x, root, mu, var, labels, want_order, 1, ordering.LocalReducer())
    assert got.shape == (*lead, m, width - 1)
    assert torch.equal(got_labels, want_labels)
    assert torch.equal(order, want_order)
    assert (order[..., 1] == 3 * col + 1).all()
    scale = x.abs().amax()
    torch.testing.assert_close(got, want, rtol=0, atol=2e-5 * float(scale))
    pad = [j - (j > col) for j in (w, w + 1) if j != col]
    assert not got[..., pad].any()


@pytest.mark.gpu
def test_cuda_step_passes_same_bits_across_widths_and_batches(cuda_device):
    """A column's mean, variance, x_std and moments and a pair's C and Gram
    entries are the same bits at two buffer widths (the second a subset of
    the first's columns, in order, as after a compaction) and at two batch
    sizes, an element's the same as the unbatched launch's."""
    from repro_torch.kernels import step_passes

    xb = _step_data(3, 5000, 100, seed=11)
    keep = torch.tensor([c for c in range(100) if c % 4 != 1],
                        device=cuda_device)  # 75 columns
    full = step_passes.standardize(xb[0].contiguous())
    narrow = step_passes.standardize(xb[0][:, keep].contiguous())
    batch3 = step_passes.standardize(xb)
    batch2 = step_passes.standardize(xb[1:].contiguous())
    torch.cuda.synchronize()

    def cols(out, idx=None, elem=None):
        x_std, c, mu, var, (cm1, cm2), gram = out
        if elem is not None:
            x_std, c, mu, var, cm1, cm2, gram = (
                t[elem] for t in (x_std, c, mu, var, cm1, cm2, gram))
        if idx is not None:
            x_std, mu, var, cm1, cm2 = (t[..., idx] for t in
                                        (x_std, mu, var, cm1, cm2))
            c, gram = c[idx][:, idx], gram[idx][:, idx]
        return x_std, c, mu, var, cm1, cm2, gram

    for a, b in zip(cols(full, keep), cols(narrow)):
        assert torch.equal(a, b)
    for a, b in zip(cols(full), cols(batch3, elem=0)):
        assert torch.equal(a, b)
    for a, b in zip(cols(batch3, elem=2), cols(batch2, elem=1)):
        assert torch.equal(a, b)


def _masked_walk_at_full_width(x):
    """The masked scan as the ordering ran it before the buffer was
    compacted at every step, from the step kernels at full width: each
    step standardizes all d columns, launches B1 at width d, scores the
    active columns, and updates the active non-root columns in place (the
    compacting update, scattered back). Yields, each step, the full
    width's statistics, moments and mask, and returns the order."""
    from repro_torch.core import ordering
    from repro_torch.kernels import step_passes

    lead, d = x.shape[:-2], x.shape[-1]
    active = torch.ones((*lead, d), dtype=torch.bool, device=x.device)
    labels = torch.arange(d, device=x.device).expand(*lead, d).contiguous()
    order = []
    for _ in range(d):
        st = step_passes.standardize(x)
        m1, m2 = ops.pairwise_moments(st[0], st[1])
        k_list = ordering.step_scores(*st[4], m1, m2, active)
        root = torch.argmax(k_list, dim=-1)
        yield st, (m1, m2), active
        order.append(root)
        if d > 1:
            upd, _ = step_passes.residualize(
                x, root, st[5], st[3], labels,
                torch.empty_like(labels), 0)
            keep = ordering.survivors(root, d)
            idx = keep[..., None, :].expand(*x.shape[:-1], d - 1)
            live = torch.gather(active, -1, keep)[..., None, :]
            x = x.scatter(-1, idx, torch.where(
                live, upd, torch.gather(x, -1, idx)))
        active = active.scatter(-1, root[..., None], False)
    return torch.stack(order, dim=-1)


def _compacted_against_masked(x):
    """Walk the masked scan at full width and the compacted loop's steps
    side by side: at every step the compacted buffer's column statistics,
    column moments, C and B1's moments are the full width's entries of
    the live columns, bit for bit. Returns (the masked walk's order, the
    order ``masked_order_impl`` gives on the card)."""
    from repro_torch.core import ordering
    from repro_torch.kernels import step_passes

    lead, d = x.shape[:-2], x.shape[-1]
    labels = torch.arange(d, device=x.device).expand(*lead, d).contiguous()
    order = torch.empty_like(labels)
    xc = x
    walk = _masked_walk_at_full_width(x)
    k = 0
    while True:
        try:
            st, (m1, m2), active = next(walk)
        except StopIteration as done:
            masked = done.value
            break
        w = d - k
        if w == 1:
            continue
        cols = labels  # the live columns, ascending
        stc = step_passes.standardize(xc)
        c1, c2 = ops.pairwise_moments(stc[0], stc[1])
        assert torch.equal(torch.gather(active, -1, cols),
                           torch.ones_like(cols, dtype=torch.bool))

        def live(t):  # (..., d) -> (..., w)
            return torch.gather(t, -1, cols)

        def live2(t):  # (..., d, d) -> (..., w, w)
            rows = torch.gather(t, -2, cols[..., :, None].expand(
                *lead, w, d))
            return torch.gather(rows, -1, cols[..., None, :].expand(
                *lead, w, w))

        for full, narrow in ((st[2], stc[2]), (st[3], stc[3]),
                             (st[4][0], stc[4][0]), (st[4][1], stc[4][1])):
            assert torch.equal(live(full), narrow)
        for full, narrow in ((st[1], stc[1]), (st[5], stc[5]), (m1, c1),
                             (m2, c2)):
            off = ~torch.eye(w, dtype=torch.bool, device=x.device)
            assert torch.equal(live2(full)[..., off], narrow[..., off])
        k_list = ordering.step_scores(*stc[4], c1, c2, torch.ones_like(
            cols, dtype=torch.bool))
        root = torch.argmax(k_list, dim=-1)
        xc, labels = step_passes.residualize(xc, root, stc[5], stc[3],
                                             labels, order, k)
        k += 1
    assert torch.equal(order, masked)
    return masked, ordering.masked_order_impl(x, ordering.LocalReducer())


@pytest.mark.gpu
@pytest.mark.parametrize("m,d", [(4096, 2), (4096, 3), (4096, 5), (4096, 8),
                                 (4096, 9), (4096, 33), (8192, 964)])
def test_cuda_compacted_order_equals_full_width_masked_scan(cuda_device, m,
                                                            d):
    """The ordering compacted at every step gives the masked scan's order
    at full width bit for bit, widths 2-7 included, and at each step the
    live columns' statistics, moments and C are the full width's. The
    facade's loop makes d - 1 steps of one standardize and one residualize
    call and one B1 launch each."""
    from repro_torch.core import ordering
    from repro_torch.kernels import step_passes

    gt = simulate_lingam(m=m, d=d, seed=100 + d)
    x = torch.as_tensor(np.ascontiguousarray(gt.data, np.float32),
                        device=cuda_device)
    if d == 964:  # a walk side by side at 964 takes minutes: orders only
        masked = _masked_walk_at_full_width(x)
        try:
            while True:
                next(masked)
        except StopIteration as done:
            want = done.value
    else:
        want, _ = _compacted_against_masked(x)
    before = (step_passes.launches, step_passes.residualize_launches,
              pairwise_stats.launches)
    got = ordering.masked_order_impl(x, ordering.LocalReducer())
    assert (step_passes.launches, step_passes.residualize_launches,
            pairwise_stats.launches) == (before[0] + d - 1,
                                         before[1] + d - 1,
                                         before[2] + d - 1)
    assert torch.equal(got, want)
    assert sorted(got.tolist()) == list(range(d))


@pytest.mark.gpu
def test_cuda_compacted_batch_equals_full_width_masked_scan(cuda_device):
    """A batch (8, 2048, 40) whose elements pick different roots at the
    same step: the compacted loop's orders are the full-width masked
    scan's, element by element, and each element's the single fit's."""
    from repro_torch.core import ordering

    xs = np.stack([np.ascontiguousarray(
        simulate_lingam(m=2048, d=40, seed=s).data, np.float32)
        for s in range(8)])
    x = torch.as_tensor(xs, device=cuda_device)
    masked, got = _compacted_against_masked(x)
    assert torch.equal(got, masked)
    assert len({tuple(o) for o in got[:, :3].tolist()}) > 1
    for k in range(8):
        single = ordering.masked_order_impl(x[k].contiguous(),
                                            ordering.LocalReducer())
        assert torch.equal(single, got[k])


@pytest.mark.gpu
@pytest.mark.parametrize("compaction", ["none", "staged"])
def test_cuda_pair_terms_counter_reads_the_needed_pairs(cuda_device,
                                                        compaction):
    """On the card both schedules compute (d + 1) d (d - 1) / 3 pair terms
    an ordering, times the batch: the benchmark's count."""
    from repro_torch import obs
    from repro_torch.core import batched
    from repro_torch.obs import metrics

    d, b = 24, 3
    xs = torch.as_tensor(np.stack([np.ascontiguousarray(
        simulate_lingam(m=1000, d=d, seed=s).data, np.float32)
        for s in range(b)]), device=cuda_device)
    cfg = api.FitConfig(compaction=compaction)
    obs.reset_all()
    obs.enable()
    try:
        api.fit_fn(xs[0], cfg)
        single = metrics.snapshot()["counters"]["order.pair_terms"]
        batched.fit_many(xs, cfg)
        both = metrics.snapshot()["counters"]["order.pair_terms"]
    finally:
        obs.disable()
        obs.reset_all()
    assert single == (d + 1) * d * (d - 1) // 3
    assert both - single == b * single


@pytest.mark.gpu
def test_cuda_staged_order_equals_masked_with_step_kernels(cuda_device):
    """The local plan on the card gives the masked scan's order (walked
    step by step at full width) for both compactions, every step through
    the kernels (one standardize and one residualize call a step, d - 1
    steps: the last column needs none; ``path="kernel"`` on each
    ``order.standardize`` span; no ``order.compact`` gather)."""
    from repro_torch import obs
    from repro_torch.core import ordering
    from repro_torch.kernels import step_passes

    gt = simulate_lingam(m=20_000, d=40, seed=5)
    x = torch.as_tensor(np.ascontiguousarray(gt.data, np.float32),
                        device=cuda_device)
    masked, _ = _compacted_against_masked(x)
    before = (step_passes.launches, step_passes.residualize_launches,
              step_passes.scores_launches)
    local = ordering.causal_order(x)
    assert (step_passes.launches, step_passes.residualize_launches,
            step_passes.scores_launches) == (
        before[0] + 39, before[1] + 39, before[2] + 39)
    obs.reset_all()
    obs.enable()
    try:
        staged = api.fit_fn(x, api.FitConfig(compaction="staged",
                                             min_stage=4)).order
        spans, todo = [], list(obs.roots())
        while todo:
            spans.append(todo.pop())
            todo += spans[-1].children
        names = [s.name for s in spans]
        paths = {s.attrs.get("path") for s in spans
                 if s.name == "order.standardize"}
        score_paths = [s.attrs.get("path") for s in spans
                       if s.name == "order.scores"]
        scored = obs.metrics.snapshot()["counters"]["order.scores_kernel"]
    finally:
        obs.disable()
        obs.reset_all()
    assert torch.equal(local, masked)
    assert torch.equal(staged, masked)
    assert paths == {"kernel"}
    assert score_paths == ["kernel"] * 39 and scored == 39
    assert "order.compact" not in names


@pytest.mark.gpu
def test_cuda_gene_screen_fit_staged_equals_masked_at_width_964(cuda_device):
    """The gene screen's estimator (adaptive lasso, lam 0.02) at 8192 x
    964 through the facade: the staged fit gives the masked scan's order,
    and so the same adjacency bit for bit; each of the 963 steps (the
    last column needs none) runs the step-pass kernels."""
    from repro_torch.core import DirectLiNGAM
    from repro_torch.data.simulate import simulate_gene_perturb
    from repro_torch.kernels import step_passes

    x, _, _ = simulate_gene_perturb(m=8192, d=964, n_interventions=248,
                                    seed=2147483693)
    fits = {}
    for compaction in ("none", "staged"):
        before = (step_passes.launches, step_passes.residualize_launches)
        fits[compaction] = DirectLiNGAM(
            prune_method="adaptive_lasso", prune_kwargs={"lam": 0.02},
            compaction=compaction).fit(x)
        assert (step_passes.launches, step_passes.residualize_launches) == (
            before[0] + 963, before[1] + 963)
    masked, staged = fits["none"], fits["staged"]
    np.testing.assert_array_equal(staged.causal_order_, masked.causal_order_)
    np.testing.assert_array_equal(staged.adjacency_, masked.adjacency_)
    assert sorted(staged.causal_order_.tolist()) == list(range(964))
    assert np.isfinite(staged.adjacency_).all()


def _score_moments(b, w, seed, device="cuda"):
    """Column and pair moments of the spread a step's have: E log cosh
    near gamma, E u exp(-u^2 / 2) near 0; (w,) and (w, w) for b None."""
    from repro_torch.core import measures

    rng = np.random.default_rng(seed)
    lead = () if b is None else (b,)
    cm1 = measures.GAMMA + 0.04 * rng.standard_normal((*lead, w))
    cm2 = 0.08 * rng.standard_normal((*lead, w))
    m1 = measures.GAMMA + 0.04 * rng.standard_normal((*lead, w, w))
    m2 = 0.08 * rng.standard_normal((*lead, w, w))
    return tuple(torch.tensor(a, dtype=torch.float32, device=device)
                 for a in (cm1, cm2, m1, m2))


def _composed_scores_root(cm1, cm2, m1, m2):
    from repro_torch.core import ordering

    active = torch.ones(cm1.shape, dtype=torch.bool, device=cm1.device)
    k_list = ordering.step_scores(cm1, cm2, m1, m2, active)
    return torch.argmax(k_list, dim=-1), k_list


@pytest.mark.gpu
@pytest.mark.parametrize("w", [2, 3, 37, 487, 964])
@pytest.mark.parametrize("b", [None, 1, 3, 32])
def test_cuda_scores_root_matches_composed(cuda_device, b, w):
    """The score kernel against the composed ``step_scores`` and
    ``torch.argmax`` on the card: the same root in every element, the
    scores within 1e-12 relative (the same float32 terms, a float64 sum in
    another order), bit for bit at w = 2 (one term a row), one counted
    call."""
    from repro_torch.kernels import step_passes

    ins = _score_moments(b, w, seed=10 * w + (b or 0))
    before = step_passes.scores_launches
    root, k_list = step_passes.scores_root(*ins)
    torch.cuda.synchronize()
    assert step_passes.scores_launches == before + 1
    want_root, want = _composed_scores_root(*ins)
    assert root.dtype == torch.int64 and root.shape == want_root.shape
    assert torch.equal(root, want_root)
    assert k_list.dtype == torch.float64
    torch.testing.assert_close(k_list, want, rtol=1e-12, atol=0)
    if w == 2:
        assert torch.equal(k_list, want)
    assert (k_list < 0).any()


@pytest.mark.gpu
@pytest.mark.parametrize("w", [7, 64, 65, 487])
def test_cuda_scores_root_first_maximum_wins_ties(cuda_device, w):
    """Tied best columns go to the first of them, as ``torch.argmax``
    gives it, on both launch plans (one launch up to 64 columns, two
    past): twins at various places, twins in two tiles, and an element
    whose columns are all alike (root 0)."""
    from repro_torch.core import measures
    from repro_torch.kernels import step_passes

    g = measures.GAMMA
    twins = [(2, 5), (0, w - 1), (), (w - 2, w - 1), (1, 3, w - 3)]
    rng = np.random.default_rng(w)
    b = len(twins)
    m1 = g + 0.05 * rng.random((b, w, w))
    m2 = 0.1 * rng.standard_normal((b, w, w))
    cm1, cm2 = np.full((b, w), g + 0.02), np.full((b, w), 0.05)
    for k, ts in enumerate(twins):
        if not ts:
            m1[k], m2[k] = g + 0.03, 0.07
        for t in ts:
            m1[k, :, t], m2[k, :, t] = g + 0.5, 0.3
        for t in ts:
            m1[k, t, :], m2[k, t, :] = g, 0.0
    ins = tuple(torch.tensor(a, dtype=torch.float32, device=cuda_device)
                for a in (cm1, cm2, m1, m2))
    root, k_list = step_passes.scores_root(*ins)
    want_root, want = _composed_scores_root(*ins)
    assert root.tolist() == [ts[0] if ts else 0 for ts in twins]
    assert torch.equal(root, want_root)
    for k, ts in enumerate(twins):
        if ts:
            assert k_list[k, list(ts)].eq(0).all()
    torch.testing.assert_close(k_list, want, rtol=1e-12, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("w", [37, 487, 964])
def test_cuda_scores_root_element_alone_as_in_batch(cuda_device, w):
    """An element's scores and root are the same bits from a launch on it
    alone as from a batch of 5, at its place in the batch."""
    from repro_torch.kernels import step_passes

    ins = _score_moments(5, w, seed=w)
    root, k_list = step_passes.scores_root(*ins)
    for k in (0, 3, 4):
        r1, k1 = step_passes.scores_root(*(t[k].contiguous() for t in ins))
        assert torch.equal(r1, root[k])
        assert torch.equal(k1, k_list[k])


@pytest.mark.gpu
@pytest.mark.parametrize("d", [64, 487])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cuda_ordering_with_the_score_kernel_equals_composed(
        cuda_device, monkeypatch, d, seed):
    """``masked_order_impl`` on (3999, d) takes the score kernel at each of
    its d - 1 steps and gives the order it gives with the composed scores
    patched in."""
    from repro_torch.core import ordering
    from repro_torch.kernels import step_passes

    gt = simulate_lingam(m=3999, d=d, seed=seed)
    x = torch.as_tensor(np.ascontiguousarray(gt.data, np.float32),
                        device=cuda_device)
    before = step_passes.scores_launches
    got = ordering.masked_order_impl(x, ordering.LocalReducer())
    assert step_passes.scores_launches == before + d - 1
    monkeypatch.setattr(step_passes, "scores_root", _composed_scores_root)
    want = ordering.masked_order_impl(x, ordering.LocalReducer())
    assert torch.equal(got, want)
    assert sorted(got.tolist()) == list(range(d))


@pytest.mark.gpu
def test_cuda_scores_root_rejects_what_it_cannot_take(cuda_device):
    from repro_torch.kernels import step_passes

    cm1, cm2, m1, m2 = _score_moments(2, 8, seed=0)
    with pytest.raises(ValueError, match="pair moments"):
        step_passes.scores_root(cm1, cm2, m1[:, :7], m2)
    with pytest.raises(ValueError, match="pair moments"):
        step_passes.scores_root(cm1[None], cm2[None], m1[None], m2[None])
    with pytest.raises(TypeError):
        step_passes.scores_root(cm1, cm2, m1.double(), m2)
    with pytest.raises(TypeError):
        step_passes.scores_root(cm1, cm2, m1.mT, m2)


@pytest.mark.gpu
def test_cuda_step_passes_reject_what_they_cannot_take(cuda_device):
    from repro_torch.kernels import step_passes

    x = _step_data(None, 256, 8)
    with pytest.raises(ValueError, match="on the card"):
        step_passes.standardize(x.cpu())
    with pytest.raises(TypeError):
        step_passes.standardize(x.double())
    with pytest.raises(TypeError):
        step_passes.standardize(x.T)
    st = step_passes.standardize(x)
    labels = torch.arange(8, device=cuda_device)
    order = torch.empty(8, dtype=torch.int64, device=cuda_device)
    root = torch.tensor(2, device=cuda_device)
    with pytest.raises(ValueError, match="root"):
        step_passes.residualize(x, root.int(), st[5], st[3], labels, order,
                                0)
    with pytest.raises(ValueError, match="gram"):
        step_passes.residualize(x, root, st[1], st[3], labels, order, 0)
    with pytest.raises(ValueError, match="labels"):
        step_passes.residualize(x, root, st[5], st[3], labels[:7], order, 0)
    with pytest.raises(ValueError, match="labels"):
        step_passes.residualize(x, root, st[5], st[3], labels, order, 1)
    with pytest.raises(ValueError, match="w >= 2"):
        x1 = x[:, :1].contiguous()
        st1 = step_passes.standardize(x1)
        step_passes.residualize(x1, root, st1[5], st1[3], labels[:1],
                                order, 0)


@pytest.mark.gpu
def test_cuda_wide_fit_builds_nothing_of_size_d_cubed(cuda_device):
    """``DirectLiNGAM().fit`` at (8,192, 2,048) through the facade's
    defaults: the OLS pruning factors one float64 (d, d) correlation and
    takes under 1 GB alone (one float32 d^3 stack would be 34 GB), and
    the whole fit stays within 1 GB of B1's split partial sums at full
    width (2 x 64 splits x d^2 float32, 2.1 GB at 8,192 rows)."""
    from repro_torch.core import DirectLiNGAM, pruning

    gt = simulate_lingam(m=8192, d=2048, edge_prob=0.0244, seed=1)
    x = np.ascontiguousarray(gt.data, dtype=np.float32)

    def peak_of(fn):
        torch.cuda.synchronize(cuda_device)
        torch.cuda.reset_peak_memory_stats(cuda_device)
        base = torch.cuda.memory_allocated(cuda_device)
        out = fn()
        torch.cuda.synchronize(cuda_device)
        return out, torch.cuda.max_memory_allocated(cuda_device) - base

    model, fit_peak = peak_of(lambda: DirectLiNGAM(device="cuda").fit(x))
    assert sorted(model.causal_order_.tolist()) == list(range(2048))
    assert np.isfinite(model.adjacency_).all()
    assert model.adjacency_[model.causal_order_[0]].tolist() == [0.0] * 2048
    partials = 2 * pairwise_stats.slab_plan(8192).n_z * 2048 ** 2 * 4
    assert fit_peak < partials + (1 << 30), (fit_peak, partials)
    xt = torch.as_tensor(x, device=cuda_device)
    order = torch.as_tensor(model.causal_order_, device=cuda_device)
    b, prune_peak = peak_of(lambda: pruning.ols_adjacency(xt, order))
    assert prune_peak < 1 << 30, prune_peak
    np.testing.assert_array_equal(b.cpu().numpy(), model.adjacency_)
