"""Port's moment kernels against the JAX reference, on the same inputs.

B1 (``pairwise_moments``), B2 (``pairwise_moment_sums_rows`` and the
chunked streaming entry over it) and B3 (``fused_moment_rows``): on the
CPU the wrappers run their kernels' plain versions.

The reference runs on the CPU as its own tests run it: the Pallas kernel
in interpret mode, the ``blocked`` backend, tuning off. Inputs are made
with numpy and standardized once by the reference, so both sides see
identical ``x_std`` and ``C``.

Tolerance: off-diagonal moments within atol 2e-6, row-tile sums within
2e-6 * m and fused sums within 4e-6 * m: the reference's own kernel
tolerances (tests/test_kernels.py); the diagonal is undefined and
callers mask it.
"""

import functools
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import nonlinearity as jnl
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.tune import Plan
from repro_torch.kernels import (build, fused_stats, nonlinearity, ops,
                                 pairwise_stats, ref)

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
    """Row-tile sums (the form the row-tile wrapper B2 returns) are the
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
    # 7813 chunks of 128 samples in 127 splits of 62 (the last ragged).
    assert pairwise_stats.split_plan(1_000_000) == (127, 62)


@pytest.mark.parametrize(
    "m,slab",
    [(333, 128), (2048, 256), (2000, 256), (1_000_000, None), (777, 96),
     (5, 7), (4095, 4095), (65_164, 1000)],
)
def test_slab_plan_z_offsets_cover_every_chunk_once(m, slab):
    """The launcher's z axis: every slab keeps split_plan(its length),
    its splits follow each other in sample order, and together they
    cover each 128-sample chunk of each slab once."""
    plan = pairwise_stats.slab_plan(m, slab)
    ranges = plan.ranges()
    assert len(ranges) == plan.n_z
    assert [r[1] for r in ranges[1:]] == [r[2] for r in ranges[:-1]]
    assert ranges[0][1] == 0 and ranges[-1][2] == m
    width = plan.slab
    for k in range(-(-m // width)):
        base, end = k * width, min(m, (k + 1) * width)
        mine = [r for r in ranges if r[0] == k]
        n, per = pairwise_stats.split_plan(end - base)
        assert len(mine) == n
        assert mine[0][1] == base and mine[-1][2] == end
        for _, begin, stop in mine:
            assert (begin - base) % pairwise_stats.ACCUM_CHUNK == 0
            assert 0 < stop - begin <= per * pairwise_stats.ACCUM_CHUNK


@pytest.mark.parametrize(
    "rows,d,n_z,tile",
    [(100, 100, 127, 4), (487, 487, 32, 4), (487, 487, 16, 4),
     (243, 243, 32, 4), (75, 75, 127, 4), (56, 56, 127, 2),
     (42, 42, 127, 2), (32, 32, 127, 1), (8, 8, 127, 1), (100, 100, 1, 1)],
)
def test_tile_choice_by_width(rows, d, n_z, tile):
    """The largest pair block that still gives every SM 8 warps; at the
    main path's widths 100 and 487 that is 4 x 4, with no padded pair at
    d = 100 and 0.4% at d = 487."""
    assert pairwise_stats.tile_for(rows, d, n_z) == tile
    blocks = -(-rows // tile) * -(-d // tile)
    if tile > 1:
        assert (blocks * n_z
                >= pairwise_stats.H100_SMS
                * pairwise_stats.FILL_THREADS_PER_SM)
    padded = blocks * tile * tile / (rows * d) - 1
    assert padded <= {100: 0.0, 487: 0.005}.get(d, 0.1)


@pytest.mark.parametrize("d,stage", [(4, 32), (100, 32), (256, 32),
                                     (487, 16), (1000, 8), (5000, 1)])
def test_stage_samples_by_width(d, stage):
    got = pairwise_stats.stage_for(d)
    assert got == stage and pairwise_stats.ACCUM_CHUNK % got == 0
    ld = -(-d // 4) * 4
    assert got == 1 or 2 * got * ld * 4 <= pairwise_stats.STAGE_BYTES


@pytest.mark.parametrize("d,tile", [(100, 4), (487, 4), (512, 4), (256, 2),
                                    (56, 2), (128, 1), (8, 1), (2, 1)])
def test_whole_rows_staged_up_to_a_block_of_pair_blocks_a_row(d, tile):
    """Up to ``THREADS`` pair blocks a row block (d <= 512 at T = 4, 256
    at T = 2, 128 at T = 1), a block stages whole sample rows, padded to
    4 floats: the launches of cells 1-4 and the streams."""
    assert pairwise_stats.staged_columns(d, tile) == ("rows", -(-d // 4) * 4)


def _block_spans(d, rows, tile):
    """(la, lb, nc) of every block of a span launch, as the kernel cuts
    them (``csrc/pairwise_moments.cu`` ``block_span``): the x_j piece in
    the first row block, the wrapped piece in the next, the x_i
    columns."""
    k = pairwise_stats.THREADS
    nbj = -(-d // tile)
    nb = -(-rows // tile) * nbj
    first = np.arange(0, nb, k)
    last = np.minimum(first + k, nb) - 1
    bi0, bi1 = first // nbj, last // nbj
    a0 = (first - bi0 * nbj) * tile
    end = np.minimum((last - bi1 * nbj + 1) * tile, d)
    wrap = bi1 > bi0
    return (np.where(wrap, d - a0, end - a0), np.where(wrap, end, 0),
            (bi1 - bi0 + 1) * tile)


@pytest.mark.parametrize("tile", pairwise_stats.TILES)
@pytest.mark.parametrize("d,rows", [(513, 513), (601, 601), (964, 964),
                                    (1027, 1027), (2047, 2047), (2048, 2048),
                                    (1027, 7), (600, 3)])
def test_span_staged_past_a_block_of_pair_blocks_a_row(d, rows, tile):
    """Past ``THREADS`` pair blocks a row block a block stages its x_j span
    (two pieces where it wraps, each at a 16-byte-aligned offset) and its
    x_i columns: every block's layout fits the staged width, 520 floats
    at T = 4, and the stage count from it divides 128 and keeps both
    buffers within ``STAGE_BYTES``."""
    staging, width = pairwise_stats.staged_columns(d, tile)
    assert staging == "span"
    assert width == {4: 520, 2: 264, 1: 136}[tile]
    la, lb, nc = _block_spans(d, rows, tile)
    assert (la > 0).all() and (la + lb <= pairwise_stats.THREADS * tile).all()
    assert (lb < d).all() and (nc <= 2 * tile).all()
    b_off = -(-la // 4) * 4
    c_off = b_off + -(-lb // 4) * 4
    assert (c_off + nc <= width).all()
    n = pairwise_stats.stage_for(width)
    assert pairwise_stats.ACCUM_CHUNK % n == 0
    assert 2 * n * width * 4 <= pairwise_stats.STAGE_BYTES
    assert n == {4: 8, 2: 16, 1: 32}[tile]


@pytest.mark.parametrize("m,d,batch,slab,spans", [
    (1_000_000, 100, 1, None, 0), (3999, 487, 1, None, 0),
    (3999, 487, 32, None, 0), (2048, 487, 1, 256, 0),
    (65_164, 964, 1, None, 452), (8192, 2048, 1, None, 1536)])
def test_span_launches_of_each_cells_ordering(m, d, batch, slab, spans):
    """Over one ordering's steps, with the heuristic pair block at each
    width, the launches that stage a span: none in cells 1-4 and the
    streams, widths 964 .. 513 in the gene cell and 2,048 .. 513 in the
    wide cell."""
    from repro_torch.core import ordering

    n_z = pairwise_stats.slab_plan(m, slab).n_z * batch
    got = sum(steps for w, steps in ordering.order_schedule(d)
              if pairwise_stats.staged_columns(
                  w, pairwise_stats.tile_for(w, w, n_z))[0] == "span")
    assert got == spans


def test_committed_plans_stage_whole_rows_to_their_bucket_width():
    """Every committed tuned plan of B1/B2 stages whole rows at the widest
    width of its bucket (``d512``: 257-512), so a tuned T never turns a
    cell's launch into a span."""
    import json
    import re
    from pathlib import Path

    path = (Path(pairwise_stats.__file__).parent / "tune"
            / "default_plans.json")
    entries = json.loads(path.read_text())["entries"]
    seen = 0
    for key, entry in entries.items():
        if entry.get("tile"):
            width = int(re.search(r"/d(\d+)\.", key).group(1))
            assert pairwise_stats.staged_columns(width, entry["tile"])[0] == (
                "rows"), key
            seen += 1
    assert seen >= 10


def test_build_key_covers_included_headers(tmp_path):
    """A changed header under csrc/ changes every source's build key, so
    a stale library is never loaded; nvcc is not needed to see it."""
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    before = {n: build.source_key(n, csrc)
              for n in ("pairwise_moments", "fused_moments")}
    assert before == {n: build.source_key(n) for n in before}
    header = csrc / "moment_terms.cuh"
    header.write_text(header.read_text() + "// touched\n")
    after = {n: build.source_key(n, csrc) for n in before}
    assert all(after[n] != before[n] for n in before)
    (csrc / "extra.cuh").write_text("#pragma once\n")
    assert build.source_key("pairwise_moments", csrc) != after[
        "pairwise_moments"]


def test_cached_build_reports_its_nvcc_log(tmp_path, monkeypatch):
    """A library loaded from the cache brings the ptxas report of the nvcc
    run that built it; a cached library without its log is rebuilt."""
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "_loaded", {})
    monkeypatch.setattr(build, "build_info", {})
    monkeypatch.setattr(build.ctypes, "CDLL", lambda path: path)
    key = build.source_key("pairwise_moments")
    lib = tmp_path / f"pairwise_moments-{key}.so"
    lib.write_bytes(b"")

    def no_nvcc():
        raise RuntimeError("nvcc called")

    monkeypatch.setattr(build, "_nvcc", no_nvcc)
    with pytest.raises(RuntimeError, match="nvcc called"):
        build.load("pairwise_moments")
    lib.with_suffix(".log").write_text("ptxas info    : Used 64 registers\n")
    assert build.load("pairwise_moments") == str(lib)
    assert build.build_info["pairwise_moments"] == {
        "seconds": 0.0, "log": "ptxas info    : Used 64 registers\n"}


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


# (tile, d, m) cells straddling the reference's block multiples
# (tests/test_kernels.py _EDGE_CELLS), each at row offset 0 and > 0.
EDGE_CELLS = [(7, 9, 127), (8, 16, 129), (9, 15, 255), (8, 17, 257),
              (16, 16, 128)]
TILES = [(tile, d, m, row0, min(tile, d - row0))
         for tile, d, m in EDGE_CELLS for row0 in (0, max(1, d - tile))]
# Plans whose blocks do not divide the cells, as the reference's tests
# force, so its wrappers pad every axis and mask the sample tail.
ROWS_PLAN = Plan(op="pairwise_moment_sums_rows", variant="pallas-row-tile",
                 backend="pallas", bi=8, bj=8, bm=128, source="override")
FUSED_PLAN = Plan(op="fused_moment_sums", variant="pallas-fused",
                  backend="pallas", bi=8, bj=8, bm=256, source="override")


def _tile_close(got, want, row0, atol):
    """Off-diagonal entries of a (rows, d) row tile starting at row0."""
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else got
    rows, d = got.shape
    mask = ~np.eye(rows, d, k=row0, dtype=bool)
    np.testing.assert_allclose(got[mask], np.asarray(want)[mask], atol=atol,
                               rtol=0)


@functools.lru_cache(maxsize=None)
def _raw(m, d):
    """Raw float32 samples with their float32 mean and 1/std (ddof=0)."""
    x = np.random.default_rng(7 * m + d).laplace(size=(m, d))
    x = (x * np.linspace(0.5, 3.0, d) + np.linspace(-2.0, 2.0, d)).astype(
        np.float32)
    mu = x.mean(axis=0, dtype=np.float64).astype(np.float32)
    rstd = (1.0 / x.std(axis=0, dtype=np.float64)).astype(np.float32)
    return x, mu, rstd


@pytest.mark.parametrize("tile,d,m,row0,rows", TILES)
def test_row_tile_plain_version_matches_pallas(tile, d, m, row0, rows):
    xs, c = _inputs(m, d)
    want = jops.pairwise_moment_sums_rows(
        jnp.asarray(xs), jnp.asarray(c), row0, rows, backend="pallas",
        interpret=True, plan=ROWS_PLAN)
    before = pairwise_stats.rows_launches
    got = ops.pairwise_moment_sums_rows(torch.from_numpy(xs),
                                        torch.from_numpy(c), row0, rows)
    assert pairwise_stats.rows_launches == before  # CPU: the plain version
    blocked = ops.pairwise_moment_sums_rows(
        torch.from_numpy(xs), torch.from_numpy(c), row0, rows,
        backend="blocked")
    for g, b, w in zip(got, blocked, want):
        assert g.dtype == torch.float32 and g.shape == (rows, d)
        _tile_close(g, w, row0, 2e-6 * m)
        _tile_close(b, w, row0, 2e-6 * m)


@pytest.mark.parametrize("chunk", [128, 96])
@pytest.mark.parametrize("backend", ["blocked", "pallas"])
def test_chunked_plain_version_matches_reference(backend, chunk):
    m, d = 333, 10
    xs, c = _inputs(m, d)
    want = jops.pairwise_moments_chunked(
        jnp.asarray(xs), jnp.asarray(c), chunk=chunk, backend=backend,
        interpret=True, tune_mode="off")
    for port_backend in (None, "blocked"):
        got = ops.pairwise_moments_chunked(
            torch.from_numpy(xs), torch.from_numpy(c), chunk=chunk,
            backend=port_backend)
        for g, w in zip(got, want):
            _offdiag_close(g, w)


def test_chunked_sums_add_one_row_tile_call_per_slab(monkeypatch):
    """The chunked entry is one slab-structured call (one kernel launch on
    a card, none on the CPU) that equals one row-tile call per slab, the
    slab sums added in order, bit for bit; a ragged last slab is
    masked."""
    xs, c = (torch.from_numpy(a) for a in _inputs(333, 10))
    calls = []
    real = pairwise_stats.pairwise_moment_sums_slabs

    def spy(x, cc, slab, **kw):
        calls.append((x.shape[0], x.data_ptr(), slab))
        return real(x, cc, slab, **kw)

    monkeypatch.setattr(pairwise_stats, "pairwise_moment_sums_slabs", spy)
    before = pairwise_stats.rows_launches
    s1, s2 = ops.pairwise_moment_sums_chunked(xs, c, chunk=128)
    assert calls == [(333, xs.data_ptr(), 128)]
    assert pairwise_stats.rows_launches == before  # CPU: the plain version
    rows = pairwise_stats.pairwise_moment_sums_rows
    parts = [rows(xs[k:k + 128], c, 0, 10) for k in (0, 128, 256)]
    assert parts[2][0].shape == (10, 10)
    assert torch.equal(s1, parts[0][0] + parts[1][0] + parts[2][0])
    assert torch.equal(s2, parts[0][1] + parts[1][1] + parts[2][1])


@pytest.mark.parametrize("tile,d,m,row0,rows", TILES)
def test_fused_plain_version_matches_pallas(tile, d, m, row0, rows):
    x, mu, rstd = _raw(m, d)
    xs = (x - mu) * rstd
    c = (xs.T.astype(np.float64) @ xs / m).astype(np.float32)
    want = jops.fused_moment_rows(
        jnp.asarray(x), jnp.asarray(mu), jnp.asarray(rstd), jnp.asarray(c),
        row0, rows, interpret=True, plan=FUSED_PLAN)
    before = fused_stats.launches
    got = ops.fused_moment_rows(torch.from_numpy(x), torch.from_numpy(mu),
                                torch.from_numpy(rstd), torch.from_numpy(c),
                                row0, rows)
    assert fused_stats.launches == before  # CPU: the plain version
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == (rows, d)
        _tile_close(g, w, row0, 4e-6 * m)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_plain_version_matches_pallas_in_both_types(dtype):
    m, d, tile = 512, 16, 8
    x, mu, rstd = _raw(m, d)
    xs = (x - mu) * rstd
    c = (xs.T.astype(np.float64) @ xs / m).astype(np.float32)
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    # Both frameworks round float32 to bfloat16 to nearest even.
    np.testing.assert_array_equal(tx.float().numpy(),
                                  np.asarray(jx.astype(jnp.float32)))
    want = jops.fused_moment_rows(jx, jnp.asarray(mu), jnp.asarray(rstd),
                                  jnp.asarray(c), 0, tile, interpret=True,
                                  plan=FUSED_PLAN)
    got = ops.fused_moment_rows(tx, torch.from_numpy(mu),
                                torch.from_numpy(rstd), torch.from_numpy(c),
                                0, tile)
    for g, w in zip(got, want):
        _tile_close(g, w, 0, 4e-6 * m)


def test_fused_plain_version_is_row_tile_of_standardized_sums():
    """On the values it standardizes to, B3's plain version is B2's."""
    x, mu, rstd = (torch.from_numpy(a) for a in _raw(777, 40))
    xs = (x - mu) * rstd
    c = ops.correlation(xs)
    f1, f2 = fused_stats.fused_moment_sums_plain(x, mu, rstd, c, row0=16,
                                                 rows=9)
    r1, r2 = pairwise_stats.pairwise_moment_sums_plain(xs, c, row0=16,
                                                       rows=9)
    assert torch.equal(f1, r1) and torch.equal(f2, r2)


def test_row_tile_and_fused_entries_reject_bad_tiles():
    xs, c = (torch.from_numpy(a) for a in _inputs(257, 10))
    x, mu, rstd = (torch.from_numpy(a) for a in _raw(257, 10))
    for row0, rows in ((8, 3), (-1, 2), (0, 0)):
        # A host-int tile out of range raises (the reference clamps).
        with pytest.raises(ValueError, match="row tile"):
            ops.pairwise_moment_sums_rows(xs, c, row0, rows)
        with pytest.raises(ValueError, match="row tile"):
            ops.fused_moment_rows(x, mu, rstd, c, row0, rows)
    with pytest.raises(ValueError, match="ref"):
        ops.pairwise_moment_sums_rows(xs, c, 0, 10, backend="ref")
    with pytest.raises(ValueError, match="cuda"):
        ops.pairwise_moment_sums_chunked(xs, c, chunk=64, backend="cuda")
    with pytest.raises(ValueError):
        fused_stats.fused_moment_sums(x, mu[:5], rstd, c, 0, 10)
