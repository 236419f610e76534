"""Port's serving engine against the JAX reference's
(tests/test_stream.py engine tests, tests/test_batched_api.py's engine
test, tests/test_monitor.py's serving tests).

Covers ``run`` against the reference engine (one batched fit per shape
part, of the real requests: the port does not pad to a power of two),
batched flushes against single sessions and against the reference
engine's deltas, the auto-flush rules (a filling session does not
starve an active one; a due refit waits at most one post), ``refit_every``,
flush isolation with the per-session fallback and with non-finite rows,
``poll_alerts`` draining each alert once, a drift-triggered flush
failure keeping its alert pending, queries against session ids, and
``warmup``.

The reference runs on the CPU with the ``blocked`` backend and tuning
off; the port with ``device="cpu"``. Tolerances: causal orders exact
(tie-free simulated data); adjacency and thetas within 1e-5 of the
single-session or reference fit (the reference test's batched-against-
single tolerance); effect answers within 1e-6 of the port's direct call.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import api as japi
from repro.serve.engine import CausalDiscoveryEngine as JEngine
from repro.serve.engine import FitRequest as JFitRequest
from repro.stream import StreamConfig as JStreamConfig
from repro_torch.core import api, batched
from repro_torch.data.simulate import (simulate_lingam, simulate_var_breaks,
                                       simulate_var_stocks)
from repro_torch.infer import effects, query
from repro_torch.serve import engine as serve_engine
from repro_torch.serve.engine import CausalDiscoveryEngine, FitRequest
from repro_torch.stream import MonitorConfig, StreamConfig, window

torch.set_num_threads(1)

CFG = api.FitConfig(compaction="staged")
JCFG = japi.FitConfig(backend="blocked", compaction="staged", tune="off")
ATOL = 1e-5


def _engine(batch_size, config=CFG):
    return CausalDiscoveryEngine(config, batch_size=batch_size, device="cpu")


def _stream_config(d, chunk, wc, **kw):
    return StreamConfig(d=d, chunk=chunk, window_chunks=wc, lags=1, fit=CFG,
                        **kw)


def _stock_chunks(d, chunk, n_chunks, seed=1):
    x, _, _ = simulate_var_stocks(m=chunk * n_chunks + 5, d=d, edge_prob=0.3,
                                  seed=seed)
    return [x[k * chunk:(k + 1) * chunk] for k in range(n_chunks)]


@pytest.fixture
def fit_many_calls(monkeypatch):
    calls = []
    for name in ("fit_many", "fit_many_from_stats"):
        real = getattr(batched, name)

        def spy(xs, *a, _real=real, _name=name, **k):
            calls.append((_name, tuple(xs.shape)))
            return _real(xs, *a, **k)

        monkeypatch.setattr(serve_engine.lingam_batched, name, spy)
    return calls


# ----------------------------------------------------------------------
# Fit requests
# ----------------------------------------------------------------------


def _requests(cls):
    return [cls(data=simulate_lingam(m=400, d=5, seed=s).data)
            for s in range(3)] + [
        cls(data=simulate_lingam(m=300, d=4, seed=9).data)]


@pytest.mark.parametrize("compaction", ["none", "staged"])
def test_engine_run_matches_reference_engine(compaction, fit_many_calls):
    reqs = _requests(FitRequest)
    jreqs = _requests(JFitRequest)
    _engine(2, api.FitConfig(compaction=compaction)).run(reqs)
    JEngine(dataclasses.replace(JCFG, compaction=compaction),
            batch_size=2).run(jreqs)
    # One batched fit per part of a shape group, of the real requests.
    assert fit_many_calls == [("fit_many", (2, 400, 5)),
                              ("fit_many", (1, 400, 5)),
                              ("fit_many", (1, 300, 4))]
    for r, jr in zip(reqs, jreqs):
        d = r.data.shape[1]
        assert isinstance(r.result.adjacency, np.ndarray)
        assert r.result.adjacency.shape == (d, d)
        np.testing.assert_array_equal(r.result.order,
                                      np.asarray(jr.result.order))
        np.testing.assert_allclose(r.result.adjacency,
                                   np.asarray(jr.result.adjacency), atol=ATOL)
        np.testing.assert_allclose(r.result.resid_var,
                                   np.asarray(jr.result.resid_var), atol=ATOL)
    one = api.fit_fn(torch.from_numpy(np.ascontiguousarray(reqs[0].data)),
                     api.FitConfig(compaction=compaction))
    np.testing.assert_array_equal(one.order.numpy(), reqs[0].result.order)


def test_engine_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CausalDiscoveryEngine()


# ----------------------------------------------------------------------
# Streams: batched flushes
# ----------------------------------------------------------------------


def test_engine_streams_batch_and_match_single_session(fit_many_calls):
    d, chunk, wc = 8, 96, 4
    cfg = _stream_config(d, chunk, wc)
    eng = _engine(2)
    jeng = JEngine(JCFG, batch_size=2)
    jcfg = JStreamConfig(d=d, chunk=chunk, window_chunks=wc, lags=1,
                         fit=JCFG)
    all_chunks = [_stock_chunks(d, chunk, wc + 2, seed=s) for s in (1, 2)]
    sids = [eng.open_stream(cfg) for _ in all_chunks]
    jsids = [jeng.open_stream(jcfg) for _ in all_chunks]
    deltas, jdeltas = [], []
    for k in range(wc + 2):
        for sid, jsid, chunks in zip(sids, jsids, all_chunks):
            deltas += eng.post_chunk(sid, chunks[k])
            jdeltas += jeng.post_chunk(jsid, chunks[k])
    # Session 0 flushes solo at window fill (session 1 is still filling
    # and must not delay it); then each round batches both sessions.
    assert len(deltas) == 5
    deltas += eng.flush_streams()
    jdeltas += jeng.flush_streams()
    assert len(deltas) == len(jdeltas) == 6
    assert deltas[0][1].refit_index == 0 and deltas[-1][1].refit_index == 2
    for (sid, got), (jsid, want) in zip(deltas, jdeltas):
        assert sids.index(sid) == jsids.index(jsid)
        assert (got.refit_index, got.n_edges) == (want.refit_index,
                                                  want.n_edges)
        np.testing.assert_array_equal(got.added, want.added)
    # Each flush part is one batched refit of the real due sessions.
    assert [c for c in fit_many_calls if c[1][0] == 2]
    assert all(name == "fit_many_from_stats" for name, _ in fit_many_calls)
    assert sum(s[0] for _, s in fit_many_calls) == 6
    # The engine's batched refit == the standalone rolling path.
    roll = window.RollingVarLiNGAM(d, chunk, wc, lags=1, config=cfg.fit,
                                   device="cpu")
    for rows in all_chunks[0]:
        roll.push(rows)
    solo = roll.refit()
    served = eng.stream_session(sids[0]).last_fit
    np.testing.assert_array_equal(solo.result.order.numpy(),
                                  served.result.order.numpy())
    np.testing.assert_allclose(solo.result.adjacency.numpy(),
                               served.result.adjacency.numpy(), atol=ATOL)
    for a, b in zip(solo.thetas, served.thetas):
        np.testing.assert_allclose(a, b, atol=ATOL)
    closed = eng.close_stream(sids[0])
    assert closed.n_refits == 3 and sids[0] not in eng._streams


def test_engine_idle_filling_session_does_not_starve_active():
    d, chunk, wc = 6, 64, 3
    cfg = _stream_config(d, chunk, wc)
    eng = _engine(8)
    active = eng.open_stream(cfg)
    eng.open_stream(cfg)  # never posts; window never fills
    deltas = []
    for rows in _stock_chunks(d, chunk, wc + 2, seed=11):
        deltas += eng.post_chunk(active, rows)
    assert len(deltas) == 3
    assert all(sid == active for sid, _ in deltas)


def test_engine_ready_idle_session_defers_at_most_one_post():
    d, chunk, wc = 6, 64, 3
    cfg = _stream_config(d, chunk, wc)
    eng = _engine(8)
    active, idle = eng.open_stream(cfg), eng.open_stream(cfg)
    chunks = _stock_chunks(d, chunk, wc + 4, seed=13)
    for rows in chunks[:wc]:
        eng.post_chunk(idle, rows)
        eng.post_chunk(active, rows)
    eng.flush_streams()
    n_before = eng.stream_session(active).n_refits
    deltas = []
    for rows in chunks[wc:]:
        deltas += eng.post_chunk(active, rows)
    assert all(sid == active for sid, _ in deltas)
    # Due after post 1, flushed at post 2; due at 3, flushed at 4.
    assert len(deltas) == 2
    assert eng.stream_session(active).n_refits == n_before + 2


def test_engine_refit_every_throttles():
    d, chunk, wc = 6, 64, 3
    eng = _engine(1)
    sid = eng.open_stream(_stream_config(d, chunk, wc, refit_every=2))
    n = sum(len(eng.post_chunk(sid, rows))
            for rows in _stock_chunks(d, chunk, wc + 4, seed=7))
    assert n == 2 and eng.stream_session(sid).n_refits == 2


def test_engine_flush_batches_the_real_due_sessions(fit_many_calls):
    """Three due sessions are one batch of three (the reference pads to
    four); a batch_size of two splits them 2 + 1."""
    d, chunk, wc = 5, 48, 3
    for batch_size, want in ((8, [3]), (2, [2, 1])):
        fit_many_calls.clear()
        eng = _engine(batch_size)
        sids = [eng.open_stream(_stream_config(d, chunk, wc))
                for _ in range(3)]
        for k, rows in enumerate(_stock_chunks(d, chunk, wc, seed=21)):
            for sid in sids:
                eng.stream_session(sid).post(rows)
        out = eng.flush_streams()
        assert sorted(s for s, _ in out) == sorted(sids)
        assert [s[0] for _, s in fit_many_calls] == want
        assert not eng.last_flush_errors


# ----------------------------------------------------------------------
# Flush failure isolation
# ----------------------------------------------------------------------


def _two_due(eng, cfg, d, chunk, wc, seed):
    sids = [eng.open_stream(cfg) for _ in range(2)]
    for rows in _stock_chunks(d, chunk, wc, seed=seed):
        for sid in sids:
            eng.stream_session(sid).post(rows)
    return sids


def test_engine_flush_isolates_failing_session(monkeypatch):
    d, chunk, wc = 6, 64, 3
    eng = _engine(8)
    good, bad = _two_due(eng, _stream_config(d, chunk, wc), d, chunk, wc, 31)

    def boom():
        raise RuntimeError("poisoned moment state")

    monkeypatch.setattr(eng.stream_session(bad).rolling, "prepare_refit",
                        boom)
    out = eng.flush_streams()
    assert [sid for sid, _ in out] == [good]
    (err,) = eng.last_flush_errors
    assert (err.sid, err.stage) == (bad, "prepare")
    assert isinstance(err.error, RuntimeError)
    assert "poisoned" in err.summary()
    assert eng.stream_session(bad).due


def test_engine_flush_isolates_a_session_with_nan_rows(fit_many_calls):
    """A window holding non-finite rows comes back as a FlushError and
    stays out of the batched refit; its peer's refit lands."""
    d, chunk, wc = 6, 64, 3
    eng = _engine(8)
    cfg = _stream_config(d, chunk, wc)
    good, bad = eng.open_stream(cfg), eng.open_stream(cfg)
    for k, rows in enumerate(_stock_chunks(d, chunk, wc, seed=35)):
        eng.stream_session(good).post(rows)
        rows = rows.copy()
        if k == 1:
            rows[5, 2] = np.nan
        eng.stream_session(bad).post(rows)
    out = eng.flush_streams()
    assert [sid for sid, _ in out] == [good]
    (err,) = eng.last_flush_errors
    assert (err.sid, err.stage) == (bad, "prepare")
    assert "not finite" in err.summary()
    assert eng.stream_session(bad).due and not eng.stream_session(good).due
    assert fit_many_calls == [("fit_many_from_stats", (1, wc * chunk - 1,
                                                       d))]
    assert np.isfinite(eng.stream_session(good).last_fit.thetas[0]).all()


def test_engine_flush_falls_back_per_session_on_bucket_failure(monkeypatch):
    d, chunk, wc = 6, 64, 3
    eng = _engine(8)
    sids = _two_due(eng, _stream_config(d, chunk, wc), d, chunk, wc, 33)

    def boom(*a, **kw):
        raise RuntimeError("bucket program OOM")

    monkeypatch.setattr(serve_engine.lingam_batched, "fit_many_from_stats",
                        boom)
    out = eng.flush_streams()
    assert sorted(sid for sid, _ in out) == sorted(sids)
    (err,) = eng.last_flush_errors
    assert (err.sid, err.stage) == ("*", "fit")


# ----------------------------------------------------------------------
# Monitored sessions through the engine
# ----------------------------------------------------------------------


def _monitored(d, chunk, wc, **kw):
    return _stream_config(d, chunk, wc, monitor=MonitorConfig(), **kw)


def test_engine_poll_alerts_drains_once():
    d, chunk, wc = 12, 100, 8
    br = simulate_var_breaks(m=6000, d=d, kind="noise_scale", seed=0,
                             at=3000)
    eng = _engine(1)
    sid = eng.open_stream(_monitored(d, chunk, wc, refit_every=2,
                                     coast_max=32))
    deltas = []
    n = (br.series.shape[0] // chunk) * chunk
    for start in range(0, n, chunk):
        deltas += eng.post_chunk(sid, br.series[start:start + chunk])
    eng.flush_streams()
    polled = eng.poll_alerts(sid)
    assert polled, "no alerts surfaced through the serve API"
    assert br.variable in {a.variable for a in polled}
    assert eng.poll_alerts(sid) == [] and eng.poll_alerts() == []
    alert_deltas = [d_ for _, d_ in deltas if d_.triggered_by == "alert"]
    assert alert_deltas and all(d_.alerts for d_ in alert_deltas)
    assert all(d_.drift_score > 0 for d_ in alert_deltas)
    assert any("drift" in d_.summary() for d_ in alert_deltas)
    assert len(list(eng.stream_session(sid).alert_history)) >= len(polled)


def test_drift_triggered_flush_failure_keeps_alert_pending(monkeypatch):
    d, chunk, wc = 12, 100, 8
    br = simulate_var_breaks(m=6000, d=d, kind="noise_scale", seed=0,
                             at=3000)
    peer_x = simulate_var_stocks(m=6000, d=d, seed=9)[0]
    eng = _engine(8)
    sid = eng.open_stream(_monitored(d, chunk, wc, refit_every=2,
                                     coast_max=32))
    peer = eng.open_stream(_stream_config(d, chunk, wc, refit_every=2))
    session = eng.stream_session(sid)
    n = (br.series.shape[0] // chunk) * chunk
    for start in range(0, n, chunk):
        eng.post_chunk(sid, br.series[start:start + chunk])
        eng.post_chunk(peer, peer_x[start:start + chunk])
        if session.pending_alerts:
            break
    else:
        pytest.fail("no alert fired")
    assert session.due
    n_pending = len(session.pending_alerts)
    peer_refits = eng.stream_session(peer).n_refits

    def boom():
        raise RuntimeError("refit blew up mid-drift")

    monkeypatch.setattr(session.rolling, "prepare_refit", boom)
    eng.stream_session(peer)._chunks_since_refit = 99  # peer due too
    out = eng.flush_streams()
    assert eng.stream_session(peer).n_refits == peer_refits + 1
    assert all(s == peer for s, _ in out)
    (err,) = [e for e in eng.last_flush_errors if e.sid == sid]
    assert err.stage == "prepare"
    assert len(session.pending_alerts) == n_pending and session.due
    monkeypatch.undo()
    out = eng.flush_streams()
    (got,) = [d_ for s, d_ in out if s == sid]
    assert got.triggered_by == "alert"
    assert len(session.pending_alerts) == 0


# ----------------------------------------------------------------------
# Queries against sessions, warm-up
# ----------------------------------------------------------------------


def test_engine_queries_resolve_stream_sessions():
    d, chunk, wc = 6, 64, 3
    eng = _engine(2)
    sid = eng.open_stream(_stream_config(d, chunk, wc))
    gt = simulate_lingam(m=chunk * (wc + 2), d=d, seed=14)
    deltas = []
    for k in range(wc + 2):
        deltas += eng.post_chunk(sid, gt.data[k * chunk:(k + 1) * chunk])
    if not deltas:
        deltas = eng.flush_streams()
    assert deltas
    session = eng.stream_session(sid)
    qs = eng.query([
        query.EffectQuery(graph=sid),
        query.InterventionQuery(graph=sid, do={1: 2.0}),
        query.RCAQuery(graph=sid, rows=gt.data[:5]),
    ])
    np.testing.assert_allclose(
        qs[0].effects, effects.total_effects(session.last_fit.result).numpy(),
        atol=1e-6)
    assert qs[1].mean[1] == pytest.approx(2.0)
    assert qs[2].result.scores.shape == (5, d)
    win_mean = session.rolling.aug_state.mean[:d].numpy()
    np.testing.assert_allclose(qs[0].graph.mean.numpy(), win_mean, atol=1e-6)
    # Re-issued queries answer from the live estimate.
    old = qs[0].effects.copy()
    gt2 = simulate_lingam(m=chunk * 2, d=d, seed=15)
    for k in range(2):
        eng.post_chunk(sid, gt2.data[k * chunk:(k + 1) * chunk])
    eng.flush_streams()
    eng.query(qs)
    fresh = effects.total_effects(session.last_fit.result).numpy()
    np.testing.assert_allclose(qs[0].effects, fresh, atol=1e-6)
    assert not np.allclose(qs[0].effects, old)
    # Fit results (numpy fields) are queryable through the engine too.
    (req,) = eng.run([FitRequest(data=gt.data)])
    (q,) = eng.query([query.EffectQuery(graph=req.result)])
    np.testing.assert_allclose(q.effects, effects.total_effects_impl(
        torch.from_numpy(req.result.adjacency),
        torch.from_numpy(req.result.order)).numpy(), atol=1e-6)


def test_engine_warmup_runs_a_fit_and_keeps_heuristic_plans():
    eng = _engine(4, api.FitConfig(compaction="staged", tune="off"))
    plans = eng.warmup([(64, 5)], streams=[_stream_config(5, 32, 3)])
    assert len(plans) == 2
    assert all(p.source == "heuristic" for p in plans.values())
    eng2 = CausalDiscoveryEngine(api.FitConfig(tune="off"), device="cpu",
                                 warmup_shapes=[(64, 5)])
    assert eng2.batch_size == 8
    x = simulate_lingam(m=64, d=5, seed=1).data
    (req,) = eng2.run([FitRequest(data=x)])
    assert sorted(req.result.order.tolist()) == list(range(5))
