"""Port's streaming layer against the JAX reference, on the same rows.

Covers ``stream.stats`` (the moment store), ``stream.window`` (the ring,
lagged rows, rolling VarLiNGAM and the from-scratch oracle), the
carry-over of a reference window's state into the port, and
``stream.session`` (sessions and graph deltas), plus the port's copy of
``BoundedRing``.

The reference runs on the CPU with the ``blocked`` backend, tuning off
and the same explicit ``moment_chunk`` as the port (it would otherwise
ask its tuner for one). The port runs with ``device="cpu"``.

Tolerances: moment states within 1e-5 absolute (means) and 1e-5 of the
largest |m2| entry (centered sums grow with the row count); causal
orders exact (tie-free simulated data); adjacency and thetas within 1e-4
(the tolerance of the reference's own rolling-vs-direct test).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import api as japi
from repro.data.simulate import simulate_var_stocks
from repro.obs.ring import BoundedRing as JBoundedRing
from repro.stream import session as jsession
from repro.stream import stats as jstats
from repro.stream import window as jwindow
from repro_torch.core import api
from repro_torch.obs.ring import BoundedRing
from repro_torch.stream import (MonitorConfig, StreamConfig, StreamSession,
                                stats, window)
from repro_torch.stream.session import graph_delta

torch.set_num_threads(1)

ATOL_STATE = 1e-5
ATOL_FIT = 1e-4
D, CHUNK, WC = 8, 96, 4
CFG = api.FitConfig(compaction="staged", moment_chunk=CHUNK)
JCFG = japi.FitConfig(backend="blocked", compaction="staged", tune="off",
                      moment_chunk=CHUNK)


def _chunks(rng, n_chunks, d, lo=20, hi=80):
    return [
        (rng.laplace(size=(int(rng.integers(lo, hi)), d))
         * rng.uniform(0.5, 3.0, d)
         + rng.uniform(-2.0, 2.0, d)).astype(np.float32)
        for _ in range(n_chunks)
    ]


def _np_state(x):
    """Two-pass (count, mean, m2) in float64."""
    x = np.asarray(x, np.float64)
    mu = x.mean(axis=0)
    xc = x - mu
    return float(len(x)), mu, xc.T @ xc


def _assert_state_close(s, count, mean, m2):
    got = s.to_numpy() if isinstance(s, stats.MomentState) else (
        np.asarray(s.count), np.asarray(s.mean), np.asarray(s.m2))
    scale = max(1.0, float(np.abs(m2).max()))
    assert float(got[0]) == pytest.approx(float(count))
    np.testing.assert_allclose(got[1], mean, atol=ATOL_STATE)
    np.testing.assert_allclose(got[2], m2, atol=ATOL_STATE * scale)


def _t(x):
    return torch.from_numpy(x)


def test_from_chunk_matches_reference_and_two_pass():
    x = _chunks(np.random.default_rng(0), 1, 6, 100, 101)[0]
    s = stats.from_chunk(_t(x))
    _assert_state_close(s, *_np_state(x))
    js = jstats.from_chunk(jnp.asarray(x))
    _assert_state_close(s, float(js.count), np.asarray(js.mean),
                        np.asarray(js.m2))
    for f, jf in ((stats.covariance, jstats.covariance),
                  (stats.variance, jstats.variance),
                  (stats.correlation, jstats.correlation)):
        np.testing.assert_allclose(f(s).numpy(), np.asarray(jf(js)),
                                   atol=ATOL_STATE)
    np.testing.assert_allclose(s.covariance.numpy(), np.cov(x.T, ddof=0),
                               atol=1e-4)


def test_merge_and_retract_match_reference():
    ca, cb = _chunks(np.random.default_rng(1), 2, 5)
    a, b = stats.from_chunk(_t(ca)), stats.from_chunk(_t(cb))
    ja, jb = jstats.from_chunk(jnp.asarray(ca)), jstats.from_chunk(
        jnp.asarray(cb))
    for got, want in ((stats.merge(a, b), jstats.merge(ja, jb)),
                      (stats.retract(stats.merge(a, b), b),
                       jstats.retract(jstats.merge(ja, jb), jb))):
        _assert_state_close(got, float(want.count), np.asarray(want.mean),
                            np.asarray(want.m2))
    _assert_state_close(a.merge(b), *_np_state(np.concatenate([ca, cb])))


def test_init_is_merge_identity_and_retract_everything_zeroes():
    x = _chunks(np.random.default_rng(2), 1, 4)[0]
    s = stats.from_chunk(_t(x))
    for merged in (stats.merge(stats.init(4, device="cpu"), s),
                   stats.merge(s, stats.init(4, device="cpu"))):
        _assert_state_close(merged, *_np_state(x))
    gone = stats.retract_chunk(
        stats.update_chunk(stats.init(4, device="cpu"), x), x)
    assert float(gone.count) == 0.0
    assert torch.isfinite(gone.mean).all() and torch.isfinite(gone.m2).all()


# The reference's hypothesis property tests (tests/test_stream.py), as
# fixed cases that run with or without hypothesis.
_PROPERTY_CASES = [(seed, d) for seed in (0, 1, 17, 2**31 - 1)
                   for d in (2, 5, 8)]


@pytest.mark.parametrize("seed,d", _PROPERTY_CASES)
def test_merge_commutative(seed, d):
    a, b = (stats.from_chunk(_t(c))
            for c in _chunks(np.random.default_rng(seed), 2, d))
    ab, ba = stats.merge(a, b), stats.merge(b, a)
    _assert_state_close(ba, *(t.numpy() for t in (ab.count, ab.mean, ab.m2)))


@pytest.mark.parametrize("seed,d", _PROPERTY_CASES)
def test_merge_associative_and_matches_direct(seed, d):
    ca, cb, cc = _chunks(np.random.default_rng(seed), 3, d)
    a, b, c = (stats.from_chunk(_t(x)) for x in (ca, cb, cc))
    want = _np_state(np.concatenate([ca, cb, cc]))
    _assert_state_close(stats.merge(stats.merge(a, b), c), *want)
    _assert_state_close(stats.merge(a, stats.merge(b, c)), *want)


@pytest.mark.parametrize("seed,d", _PROPERTY_CASES)
def test_update_retract_roundtrip(seed, d):
    """Absorb b, later retract b: back on the two-pass state of a, and on
    the reference's own round trip."""
    ca, cb = _chunks(np.random.default_rng(seed), 2, d)
    s = stats.init(d, device="cpu").update_chunk(ca).update_chunk(cb)
    back = s.retract_chunk(cb)
    _assert_state_close(back, *_np_state(ca))
    js = jstats.retract_chunk(jstats.update_chunk(
        jstats.update_chunk(jstats.init(d), ca), cb), cb)
    _assert_state_close(back, float(js.count), np.asarray(js.mean),
                        np.asarray(js.m2))


def test_moment_state_numpy_round_trip():
    x = _chunks(np.random.default_rng(3), 1, 3)[0]
    s = stats.from_chunk(_t(x))
    count, mean, m2 = s.to_numpy()
    again = stats.MomentState.from_numpy(count, mean, m2, device="cpu")
    for a, b in zip((again.count, again.mean, again.m2),
                    (s.count, s.mean, s.m2)):
        assert a.dtype == torch.float32 and torch.equal(a, b)


def _stock_chunks(n_chunks, seed=1, d=D, chunk=CHUNK):
    x, _, _ = simulate_var_stocks(m=chunk * n_chunks + 5, d=d, edge_prob=0.3,
                                  seed=seed)
    return [x[k * chunk:(k + 1) * chunk] for k in range(n_chunks)]


def _assert_fits_close(got, want):
    np.testing.assert_array_equal(got.result.order.numpy(),
                                  np.asarray(want.result.order))
    np.testing.assert_allclose(got.result.adjacency.numpy(),
                               np.asarray(want.result.adjacency),
                               atol=ATOL_FIT)
    assert len(got.thetas) == len(want.thetas)
    for g, w in zip(got.thetas, want.thetas):
        np.testing.assert_allclose(g, np.asarray(w), atol=ATOL_FIT)
    assert got.n_rows == want.n_rows


def test_rolling_matches_reference_rolling_at_every_refit():
    roll = window.RollingVarLiNGAM(D, CHUNK, WC, config=CFG, device="cpu")
    jroll = jwindow.RollingVarLiNGAM(D, CHUNK, WC, config=JCFG)
    n_checked = 0
    for rows in _stock_chunks(WC + 3):
        roll.push(rows)
        jroll.push(rows)
        assert roll.ready == jroll.ready
        if not roll.ready:
            continue
        _assert_state_close(roll.aug_state, float(jroll.aug_state.count),
                            np.asarray(jroll.aug_state.mean),
                            np.asarray(jroll.aug_state.m2))
        _assert_fits_close(roll.refit(), jroll.refit())
        n_checked += 1
    assert n_checked == 4  # 3 of them after a retraction


def test_rolling_matches_direct_window_fit():
    roll = window.RollingVarLiNGAM(D, CHUNK, WC, config=CFG, device="cpu")
    for rows in _stock_chunks(WC + 3, seed=2):
        roll.push(rows)
        if not roll.ready:
            continue
        got = roll.refit()
        want = window.direct_window_fit(list(roll.ring), roll._lead_tail,
                                        config=roll.config, device="cpu")
        np.testing.assert_array_equal(got.result.order.numpy(),
                                      want.result.order.numpy())
        np.testing.assert_allclose(got.result.adjacency.numpy(),
                                   want.result.adjacency.numpy(),
                                   atol=ATOL_FIT)
        for g, w in zip(got.thetas, want.thetas):
            np.testing.assert_allclose(g, w, atol=ATOL_FIT)


def test_direct_window_fit_matches_reference():
    chunks = _stock_chunks(WC + 1, seed=3)
    lead = chunks[0][-1:]
    got = window.direct_window_fit(chunks[1:], lead, config=CFG,
                                   device="cpu")
    want = jwindow.direct_window_fit(chunks[1:], lead, config=JCFG)
    _assert_fits_close(got, want)


def test_moment_chunk_defaults_to_the_stream_chunk():
    roll = window.RollingVarLiNGAM(D, 64, 3, device="cpu")
    assert roll.config.moment_chunk == 64
    assert roll.config.compaction == "staged"


def test_rolling_reanchor_preserves_estimate():
    d, chunk, wc = 6, 80, 3
    chunks = _stock_chunks(wc + 2, seed=5, d=d, chunk=chunk)
    roll = window.RollingVarLiNGAM(d, chunk, wc, device="cpu")
    anchored = window.RollingVarLiNGAM(d, chunk, wc, reanchor_every=1,
                                       device="cpu")
    for rows in chunks:
        roll.push(rows)
        anchored.push(rows)
    a, b = roll.refit(), anchored.refit()
    np.testing.assert_array_equal(a.result.order.numpy(),
                                  b.result.order.numpy())
    np.testing.assert_allclose(a.result.adjacency.numpy(),
                               b.result.adjacency.numpy(), atol=ATOL_FIT)
    # The anchored state is the direct two-pass over the live window.
    aug = np.concatenate([window.lagged_rows(buf, 1)
                          for buf in anchored._window_bufs()])
    _assert_state_close(anchored.aug_state, *_np_state(aug))


def test_rolling_push_copies_caller_buffer_and_validates():
    chunks = _stock_chunks(WC, seed=9)
    reused = window.RollingVarLiNGAM(D, CHUNK, WC, device="cpu")
    fresh = window.RollingVarLiNGAM(D, CHUNK, WC, device="cpu")
    buf = np.empty((CHUNK, D), np.float32)
    for rows in chunks:
        buf[:] = rows
        reused.push(buf)
        fresh.push(rows)
    assert torch.equal(reused.refit().result.adjacency,
                       fresh.refit().result.adjacency)
    with pytest.raises(ValueError, match="chunk"):
        window.RollingVarLiNGAM(4, 1, 3, device="cpu")
    with pytest.raises(ValueError, match="lags"):
        window.RollingVarLiNGAM(4, 8, 3, lags=0, device="cpu")
    roll = window.RollingVarLiNGAM(4, 32, 3, device="cpu")
    with pytest.raises(RuntimeError, match="not full"):
        roll.refit()
    with pytest.raises(ValueError, match="expected"):
        roll.push(np.zeros((16, 4), np.float32))


def _window_snapshot(roll):
    s = roll.aug_state
    return (float(s.count), s.mean.clone(), s.m2.clone(),
            [b.copy() for b in roll.ring], roll._prev_tail.copy(),
            None if roll._lead_tail is None else roll._lead_tail.copy(),
            roll.n_pushed)


def _assert_same_window(a, b):
    assert a[0] == b[0] and a[6] == b[6]
    assert torch.equal(a[1], b[1]) and torch.equal(a[2], b[2])
    assert len(a[3]) == len(b[3])
    assert all(np.array_equal(x, y) for x, y in zip(a[3], b[3]))
    assert np.array_equal(a[4], b[4])
    assert (a[5] is None) == (b[5] is None)
    assert a[5] is None or np.array_equal(a[5], b[5])


@pytest.mark.parametrize("bad", [np.nan, np.inf, -np.inf])
def test_rolling_push_rejects_non_finite_rows(bad):
    """A non-finite value is refused before any state moves (the window
    would stay non-finite after its chunk's eviction), and the window
    then refits as one that never saw it."""
    chunks = _stock_chunks(WC + 3, seed=4)
    roll = window.RollingVarLiNGAM(D, CHUNK, WC, config=CFG, device="cpu")
    clean = window.RollingVarLiNGAM(D, CHUNK, WC, config=CFG, device="cpu")
    for k, rows in enumerate(chunks):
        if k == 1:
            before = _window_snapshot(roll)
            poisoned = rows.copy()
            poisoned[7, 3] = bad
            with pytest.raises(ValueError, match="non-finite"):
                roll.push(poisoned)
            _assert_same_window(_window_snapshot(roll), before)
        roll.push(rows)
        clean.push(rows)
    assert torch.isfinite(roll.aug_state.m2).all()
    got, want = roll.refit(), clean.refit()
    np.testing.assert_array_equal(got.result.order.numpy(),
                                  want.result.order.numpy())
    assert torch.equal(got.result.adjacency, want.result.adjacency)


def test_session_post_of_non_finite_rows_leaves_it_refitting():
    chunks = _stock_chunks(WC + 2, seed=5)
    session = StreamSession("s", StreamConfig(d=D, chunk=CHUNK,
                                              window_chunks=WC, fit=CFG),
                            device="cpu")
    twin = StreamSession("t", StreamConfig(d=D, chunk=CHUNK,
                                           window_chunks=WC, fit=CFG),
                         device="cpu")
    for k, rows in enumerate(chunks):
        if k == WC:
            with pytest.raises(ValueError, match="non-finite"):
                session.post(np.full_like(rows, np.nan))
        session.post(rows)
        twin.post(rows)
    assert session.n_chunks == twin.n_chunks == WC + 2
    session.refit_now()
    twin.refit_now()
    np.testing.assert_array_equal(session.last_fit.result.order.numpy(),
                                  twin.last_fit.result.order.numpy())


def test_rolling_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        window.RollingVarLiNGAM(D, CHUNK, WC)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        StreamSession("s", StreamConfig(d=D, chunk=CHUNK, window_chunks=WC))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        window.direct_window_fit(_stock_chunks(2), None)


def test_moment_store_without_a_card_raises(monkeypatch):
    """The store's entry points default to the card, like the facades."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        stats.init(4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        stats.MomentState.from_numpy(1.0, np.zeros(4), np.zeros((4, 4)))
    assert stats.init(4, device="cpu").mean.device.type == "cpu"


@pytest.mark.parametrize("n,lags", [(5, 1), (6, 2), (3, 2)])
def test_lagged_rows_match_reference(n, lags):
    buf = np.arange(n * 3, dtype=np.float32).reshape(n, 3)
    got = window.lagged_rows(buf, lags)
    np.testing.assert_array_equal(got, jwindow.lagged_rows(buf, lags))
    assert got.shape == (n - lags, (lags + 1) * 3)
    np.testing.assert_array_equal(got[0, 3:6], buf[lags - 1])


@pytest.mark.parametrize("n,lags", [(1, 1), (2, 2)])
def test_lagged_rows_need_more_rows_than_lags(n, lags):
    buf = np.zeros((n, 3), np.float32)
    with pytest.raises(ValueError, match="lags"):
        window.lagged_rows(buf, lags)


def test_chunk_ring_matches_reference():
    ring, jring = window.ChunkRing(3), jwindow.ChunkRing(3)
    for k in range(6):
        block = np.full((2, 2), k, np.float32)
        out, jout = ring.push(block), jring.push(block)
        assert (out is None) == (jout is None)
        if out is not None:
            np.testing.assert_array_equal(out, jout)
        assert (len(ring), ring.full) == (len(jring), jring.full)
    assert [int(b[0, 0]) for b in ring] == [3, 4, 5]
    for cap in (0, 1):
        with pytest.raises(ValueError, match="ring"):
            window.ChunkRing(cap)


def test_reference_window_state_carries_into_the_port():
    """A reference window's state (ring, tails, push count, moments) is
    loaded into the port; both refit alike, then slide on alike."""
    chunks = _stock_chunks(WC + 3, seed=4)
    jroll = jwindow.RollingVarLiNGAM(D, CHUNK, WC, config=JCFG)
    for rows in chunks[:WC + 1]:
        jroll.push(rows)
    roll = window.RollingVarLiNGAM(D, CHUNK, WC, config=CFG, device="cpu")
    s = jroll.aug_state
    roll.load_state(list(jroll.ring), jroll._lead_tail, jroll._prev_tail,
                    jroll.n_pushed,
                    (np.asarray(s.count), np.asarray(s.mean),
                     np.asarray(s.m2)))
    assert roll.ready and roll.n_pushed == WC + 1
    _assert_fits_close(roll.refit(), jroll.refit())
    for rows in chunks[WC + 1:]:
        roll.push(rows)
        jroll.push(rows)
        _assert_fits_close(roll.refit(), jroll.refit())
    with pytest.raises(ValueError, match="augmented"):
        roll.load_state(list(jroll.ring), None, None, 0,
                        (1.0, np.zeros(3), np.zeros((3, 3))))
    with pytest.raises(ValueError, match="blocks"):
        roll.load_state([chunks[0]] * (WC + 1), None, None, 0,
                        (np.asarray(s.count), np.asarray(s.mean),
                         np.asarray(s.m2)))


def test_graph_delta_matches_reference():
    rng = np.random.default_rng(6)
    prev = rng.normal(scale=0.2, size=(5, 5))
    new = prev + rng.normal(scale=0.1, size=(5, 5))
    for p in (None, prev):
        got = graph_delta(p, new, 0.15, refit_index=2)
        want = jsession.graph_delta(p, new, 0.15, refit_index=2)
        for field in ("refit_index", "n_edges", "max_abs_change",
                      "frob_change"):
            assert getattr(got, field) == pytest.approx(getattr(want, field))
        np.testing.assert_array_equal(got.added, want.added)
        np.testing.assert_array_equal(got.removed, want.removed)
    assert "refit 2" in got.summary()


def _drive(session, chunks):
    """Post every chunk, refit whenever due; the due sequence and the
    deltas."""
    dues, deltas = [], []
    for rows in chunks:
        due = session.post(rows)
        dues.append(due)
        if due:
            assert session.due_wait_s() >= 0.0
            deltas.append(session.refit_now())
            assert session.due_wait_s() is None
    return dues, deltas


@pytest.mark.parametrize("coast_max,threshold", [(0, 0.05), (4, 0.25)])
def test_session_matches_reference(coast_max, threshold):
    kw = dict(d=D, chunk=CHUNK, window_chunks=WC, lags=1, refit_every=1,
              delta_threshold=threshold, coast_max=coast_max)
    port = StreamSession("s", StreamConfig(fit=CFG, **kw), device="cpu")
    ref = jsession.StreamSession("s", jsession.StreamConfig(fit=JCFG, **kw))
    chunks = _stock_chunks(WC + 8, seed=11)
    dues, deltas = _drive(port, chunks)
    jdues, jdeltas = _drive(ref, chunks)
    assert dues == jdues
    assert (port.n_refits, port.n_chunks, port.cadence) == (
        ref.n_refits, ref.n_chunks, ref.cadence)
    assert port.n_refits == len(deltas) >= 3
    for g, w in zip(deltas, jdeltas):
        assert (g.refit_index, g.n_edges, g.triggered_by) == (
            w.refit_index, w.n_edges, w.triggered_by)
        np.testing.assert_array_equal(g.added, w.added)
        np.testing.assert_array_equal(g.removed, w.removed)
        assert g.max_abs_change == pytest.approx(w.max_abs_change,
                                                 abs=ATOL_FIT)
    if coast_max:
        assert sum(dues) < len(chunks) - WC + 1  # the cadence coasted
    else:
        assert all(dues[WC - 1:])
    _assert_fits_close(port.last_fit, ref.last_fit)
    assert _bucket(port)[1] == port.rolling.config


def _bucket(session):
    from repro_torch.stream.session import bucket_key

    return bucket_key(session, session.rolling.prepare_refit())


def test_session_alert_makes_due_and_resets_cadence():
    cfg = StreamConfig(d=D, chunk=CHUNK, window_chunks=WC, fit=CFG,
                       refit_every=3)
    session = StreamSession("s", cfg, device="cpu")
    chunks = _stock_chunks(WC, seed=12)
    for rows in chunks:
        assert not session.post(rows)  # full, but refit_every=3
    session.absorb_alerts(["drift"])
    assert session.due
    delta = session.refit_now()
    assert delta.triggered_by == "alert" and delta.alerts == ["drift"]
    assert not session.due and not session.pending_alerts
    assert list(session.alert_history) == ["drift"]


def test_session_accepts_and_arms_a_monitor():
    """``StreamConfig(monitor=...)`` builds the port's drift monitor, which arms on the first fit
    (the monitor's own checks are in tests/test_torch_monitor.py)."""
    session = StreamSession("s", StreamConfig(
        d=D, chunk=CHUNK, window_chunks=WC, fit=CFG,
        monitor=MonitorConfig()), device="cpu")
    assert session.monitor is not None and not session.monitor.armed
    for rows in _stock_chunks(WC, seed=13):
        session.post(rows)
    delta = session.refit_now()
    assert session.monitor.armed and delta.drift_score == 0.0


def test_bounded_ring_copy_behaves_as_reference():
    ring, jring = BoundedRing(3, [0]), JBoundedRing(3, [0])
    for r in (ring, jring):
        r.extend(range(1, 6))
    assert list(ring) == list(jring) == [3, 4, 5]
    assert ring.dropped == jring.dropped == 3
    assert (len(ring), bool(ring), ring.maxlen, ring[0], ring[-1:]) == (
        len(jring), bool(jring), jring.maxlen, jring[0], jring[-1:])
    assert ring.drain() == jring.drain() == [3, 4, 5]
    assert not ring and ring.dropped == 3
    ring.append(1)
    ring.clear()
    assert len(ring) == 0 and ring.dropped == 0
    with pytest.raises(ValueError):
        BoundedRing(0)


def test_stream_session_config_is_hashable_and_frozen():
    cfg = StreamConfig(d=D, chunk=CHUNK, window_chunks=WC, fit=CFG)
    assert hash(cfg) == hash(dataclasses.replace(cfg))
    with pytest.raises(dataclasses.FrozenInstanceError):
        cfg.d = 3
