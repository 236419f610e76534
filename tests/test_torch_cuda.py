"""The CUDA kernels against their plain versions, on the card.

Imports neither jax nor the JAX package, so it runs on a machine that
has only PyTorch and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py

Skips without a card. Tolerances: off-diagonal moments within atol 2e-6
(B1), row-tile sums within 2e-6 * m (B2) and fused sums within 4e-6 * m
(B3), the reference's own kernel tolerances; repeat launches
bit-identical, and bit-identical across buffer widths, tile shapes, the
slab-structured launch against per-slab launches, and a batched launch
against the launches on each element. Every pair-block candidate of the
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
durations within 1 ms of their mirrored ranges.
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
    assert pairwise_stats.launches == before + 6  # one per ordering step
    res_l = bootstrap.bootstrap_lingam(gt.data, strategy="loop", **kw)
    assert pairwise_stats.launches == before + 6 + 6 * 6
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
    assert pairwise_stats.launches == before + 5  # vmap: one per step
    bootstrap.bootstrap_lingam(gt.data, max_vmap_bytes=need - 1, **kw)
    assert pairwise_stats.launches == before + 5 + 3 * 5  # the loop
    bootstrap.bootstrap_lingam(gt.data, **kw)  # the card's free memory
    assert pairwise_stats.launches == before + 5 + 15 + 5


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
    assert pairwise_stats.launches == before + 7  # one batched fit
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
    # One B2 launch per ordering step for each batched refit: a flush
    # whose windows differ in length (one has slid, one has not) holds two.
    assert flushes and all(n % d == 0 for _, n in flushes)
    assert (2, d) in flushes
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
    ordering step, orders equal to the sequential loop's or parting only
    at a tie (the row raises otherwise)."""
    from benchmarks import torch_speedup

    row = torch_speedup.shape_row(1000, 8, cuda_device, reps=1)
    assert row["b1_launches_per_ordering"] == 8
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
    assert len(moments) == 16
    assert all(s.attrs["tile"] in pairwise_stats.TILES for s in moments)
