"""Port's drift monitor against the JAX reference (tests/test_monitor.py).

Covers ``chunk_drift_stats`` on the same chunk moments and served graph
(and over a leading batch axis), the CUSUM banks along a monitored
stream beside the reference's, alerts on each break kind with the
reference's variable, kind and chunk, no alarms on a stationary stream,
``score_chunks_many`` equal to sequential scoring, no extra row pass for
monitoring, the adaptive cadence, root-candidate ranking, and the
``simulate_var_breaks`` copy pinned to the original.

The reference runs on the CPU with the ``blocked`` backend and tuning
off; the port runs with ``device="cpu"``. Tolerances: the statistics
within 1e-4 relative and 2e-3 absolute of the reference's (float32
moments, the variance statistic differences ~1 scaled by sqrt(n / 2));
the CUSUM banks along a stream within 5e-3 absolute (sums of such
statistics over a few chunks); per-element against batched statistics
within 1e-5 relative and 1e-4 absolute.
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import api as japi
from repro.data import simulate as jsimulate
from repro.infer import rca as jrca
from repro.stream import MonitorConfig as JMonitorConfig
from repro.stream import StreamConfig as JStreamConfig
from repro.stream import StreamSession as JStreamSession
from repro.stream import monitor as jmonitor
from repro_torch.core import api
from repro_torch.data.simulate import (BREAK_KINDS, simulate_var_breaks,
                                       simulate_var_stocks)
from repro_torch.infer import rca
from repro_torch.stream import (MonitorConfig, StreamConfig, StreamSession,
                                monitor as monitor_lib, stats, window)

torch.set_num_threads(1)

CFG = api.FitConfig(compaction="staged")
JCFG = japi.FitConfig(backend="blocked", compaction="staged", tune="off")
RTOL_Z, ATOL_Z = 1e-4, 2e-3
ATOL_BANK = 5e-3


def _cfg(d, chunk, wc, **kw):
    kw.setdefault("monitor", MonitorConfig())
    return StreamConfig(d=d, chunk=chunk, window_chunks=wc, lags=1, fit=CFG,
                        **kw)


def _jcfg(d, chunk, wc, **kw):
    kw.setdefault("monitor", JMonitorConfig())
    return JStreamConfig(d=d, chunk=chunk, window_chunks=wc, lags=1,
                         fit=JCFG, **kw)


def _session(d, chunk, wc, **kw):
    return StreamSession("s", _cfg(d, chunk, wc, **kw), device="cpu")


def _drive(session, series, *, refit=True):
    """Post a series chunk by chunk, refitting whenever due."""
    chunk = session.config.chunk
    n = (series.shape[0] // chunk) * chunk
    for start in range(0, n, chunk):
        if session.post(series[start:start + chunk]) and refit:
            session.refit_now()


def _served(rng, d, k=1):
    b0 = np.tril(rng.normal(scale=0.5, size=(d, d)), k=-1) * (
        rng.random((d, d)) < 0.4)
    return dict(
        a=(0.2 * rng.normal(size=(d, k * d))).astype(np.float32),
        intercept=rng.normal(scale=0.1, size=d).astype(np.float32),
        b0=b0.astype(np.float32),
        resid_var=rng.uniform(0.5, 2.0, size=d).astype(np.float32),
    )


def _chunk_moments(rng, d, n=300, scale=1.0):
    x = (rng.laplace(size=(n + 1, d)) * scale).astype(np.float32)
    return stats.from_chunk(torch.from_numpy(window.lagged_rows(x, 1)))


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ----------------------------------------------------------------------
# The statistics
# ----------------------------------------------------------------------


@pytest.mark.parametrize("seed,d,scale", [(0, 5, 1.0), (1, 12, 2.5),
                                          (2, 30, 0.7)])
def test_chunk_drift_stats_match_reference(seed, d, scale):
    rng = np.random.default_rng(seed)
    g = _served(rng, d)
    cs = _chunk_moments(rng, d, scale=scale)
    got = monitor_lib.chunk_drift_stats(cs.count, cs.mean, cs.m2,
                                        *(_t(g[k]) for k in (
                                            "a", "intercept", "b0",
                                            "resid_var")))
    want = jmonitor.chunk_drift_stats(
        jnp.asarray(cs.count.numpy()), jnp.asarray(cs.mean.numpy()),
        jnp.asarray(cs.m2.numpy()), *(jnp.asarray(g[k]) for k in (
            "a", "intercept", "b0", "resid_var")))
    for a, b in zip(got, want):
        assert a.shape == (d,)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL_Z,
                                   atol=ATOL_Z)


def test_chunk_drift_stats_over_a_batch_equal_each_chunk():
    rng = np.random.default_rng(3)
    d = 7
    graphs = [_served(rng, d) for _ in range(3)]
    states = [_chunk_moments(rng, d, scale=s) for s in (1.0, 2.0, 0.5)]
    batched = monitor_lib.chunk_drift_stats(
        torch.stack([s.count for s in states]),
        torch.stack([s.mean for s in states]),
        torch.stack([s.m2 for s in states]),
        *(torch.stack([_t(g[k]) for g in graphs])
          for k in ("a", "intercept", "b0", "resid_var")))
    for i, (g, s) in enumerate(zip(graphs, states)):
        one = monitor_lib.chunk_drift_stats(
            s.count, s.mean, s.m2,
            *(_t(g[k]) for k in ("a", "intercept", "b0", "resid_var")))
        for a, b in zip(batched, one):
            np.testing.assert_allclose(a[i].numpy(), b.numpy(), rtol=1e-5,
                                       atol=1e-4)


def test_chunk_drift_stats_unit_scale_under_model():
    """Data generated by the served model itself yields ~unit-scale
    statistics (the reference test's bounds)."""
    rng = np.random.default_rng(0)
    d, n = 5, 400
    b0 = np.zeros((d, d), np.float32)
    b0[3, 1] = 0.7
    zs = []
    for _ in range(40):
        e = rng.normal(size=(n + 1, d)).astype(np.float32)
        x = np.linalg.solve(np.eye(d) - b0, e.T).T.astype(np.float32)
        cs = stats.from_chunk(torch.from_numpy(window.lagged_rows(x, 1)))
        zs.append([z.numpy() for z in monitor_lib.chunk_drift_stats(
            cs.count, cs.mean, cs.m2, torch.zeros((d, d)),
            torch.zeros(d), torch.from_numpy(b0), torch.ones(d))])
    z = np.asarray(zs)
    assert abs(z[:, 0].mean()) < 0.3
    assert 0.6 < z[:, 0].std() < 1.5
    assert abs(z[:, 1].mean()) < 0.5
    assert abs(z[:, 2].mean()) < 0.7


# ----------------------------------------------------------------------
# Along a stream, beside the reference
# ----------------------------------------------------------------------


def test_cusum_banks_match_reference_along_a_stream():
    """A monitored session and the reference's, fed the same tie-free
    stream: the same refits, and CUSUM banks equal within ATOL_BANK after
    every post."""
    d, chunk, wc = 8, 96, 4
    x = simulate_var_stocks(m=chunk * (wc + 8) + 5, d=d, edge_prob=0.3,
                            seed=11)[0]
    port = _session(d, chunk, wc, refit_every=2)
    ref = JStreamSession("s", _jcfg(d, chunk, wc, refit_every=2))
    n_compared = 0
    for k in range(wc + 8):
        rows = x[k * chunk:(k + 1) * chunk]
        assert port.post(rows) == ref.post(rows)
        if port.monitor.armed:
            np.testing.assert_allclose(port.monitor._pos, ref.monitor._pos,
                                       atol=ATOL_BANK)
            np.testing.assert_allclose(port.monitor._neg, ref.monitor._neg,
                                       atol=ATOL_BANK)
            n_compared += 1
        if port.due:
            port.refit_now()
            ref.refit_now()
            np.testing.assert_array_equal(
                port.last_fit.result.order.numpy(),
                np.asarray(ref.last_fit.result.order))
    assert n_compared >= 6
    assert port.monitor.n_scored == ref.monitor.n_scored


@pytest.mark.parametrize("kind", BREAK_KINDS)
def test_break_alerts_match_reference(kind):
    """Each break kind (the reference tests' magnitude): the first alert
    after the break names the same variable, kind and chunk as the
    reference's, and the broken variable is implicated."""
    d, chunk, wc = 12, 100, 8
    br = simulate_var_breaks(m=6000, d=d, kind=kind, seed=0, at=3000)
    port = _session(d, chunk, wc, refit_every=2, coast_max=32)
    ref = JStreamSession("s", _jcfg(d, chunk, wc, refit_every=2,
                                    coast_max=32))
    _drive(port, br.series)
    _drive(ref, br.series)
    after = br.at // chunk
    post = [a for a in port.alert_history if a.chunk_index > after]
    jpost = [a for a in ref.alert_history if a.chunk_index > after]
    assert post and jpost, f"{kind}: no post-break alert"
    assert (post[0].variable, post[0].kind, post[0].chunk_index) == (
        jpost[0].variable, jpost[0].kind, jpost[0].chunk_index)
    assert post[0].stat == pytest.approx(jpost[0].stat, rel=1e-3, abs=1e-2)
    implicated = {a.variable for a in post} | {
        v for a in post for v, _ in a.candidate_roots[:2]}
    assert br.variable in implicated
    assert all(a.score >= 1.0 and a.candidate_roots for a in post)


def test_stationary_stream_no_alarms():
    d, chunk, wc = 8, 100, 6
    x = simulate_var_stocks(m=8000, d=d, seed=11)[0]
    s = _session(d, chunk, wc, refit_every=2, coast_max=32)
    _drive(s, x)
    assert len(s.alert_history) == 0
    assert s.monitor.n_scored > 30


def test_noise_scale_break_classified_and_fast():
    d, chunk, wc = 12, 100, 8
    br = simulate_var_breaks(m=6000, d=d, kind="noise_scale", seed=1,
                             at=3000)
    s = _session(d, chunk, wc, refit_every=2, coast_max=32)
    _drive(s, br.series)
    first = [a for a in s.alert_history if a.chunk_index > br.at // chunk][0]
    assert first.kind == "noise-scale"
    assert first.variable == br.variable
    assert first.chunk_index - br.at // chunk <= 3


def test_monitoring_adds_zero_row_passes(monkeypatch):
    """A monitored session makes exactly as many chunk-moment passes
    (``stats.from_chunk``, the only entry that reads rows) as an
    unmonitored one over the same stream."""
    d, chunk, wc = 6, 64, 3
    x = simulate_var_stocks(m=chunk * (wc + 6) + 4, d=d, seed=5)[0]
    calls = {"n": 0}
    real = stats.from_chunk

    def counting(rows):
        calls["n"] += 1
        return real(rows)

    monkeypatch.setattr(window.stats, "from_chunk", counting)

    def drive(config):
        calls["n"] = 0
        s = StreamSession("s", config, device="cpu")
        for k in range(wc + 5):
            if s.post(x[k * chunk:(k + 1) * chunk]):
                s.refit_now()
        return s, calls["n"]

    _, n_plain = drive(StreamConfig(d=d, chunk=chunk, window_chunks=wc,
                                    lags=1, fit=CFG))
    s_mon, n_monitored = drive(_cfg(d, chunk, wc))
    assert s_mon.monitor.armed and s_mon.monitor.n_scored > 0
    assert n_monitored == n_plain


# ----------------------------------------------------------------------
# Batched scoring, cadence, ranking
# ----------------------------------------------------------------------


def _armed_monitor_and_chunks(seed, d=6, chunk=64, wc=3, n_extra=3):
    x = simulate_var_stocks(m=chunk * (wc + n_extra) + 4, d=d, seed=seed)[0]
    s = StreamSession("s%d" % seed, _cfg(d, chunk, wc), device="cpu")
    for k in range(wc):
        if s.post(x[k * chunk:(k + 1) * chunk]):
            s.refit_now()
    if not s.monitor.armed:
        s.refit_now()
    chunk_states = []
    for k in range(wc, wc + n_extra):
        rows = x[k * chunk:(k + 1) * chunk]
        aug = window.lagged_rows(
            np.concatenate([x[k * chunk - 1:k * chunk], rows]), 1)
        chunk_states.append(stats.from_chunk(torch.from_numpy(aug)))
    return s.monitor, chunk_states


def test_score_chunks_many_matches_sequential():
    mons, states = [], []
    for seed in (0, 1, 2):
        m, cs = _armed_monitor_and_chunks(seed)
        mons.append(m)
        states.append(cs[0])
    seq = [copy.deepcopy(m) for m in mons]
    out_batch = monitor_lib.score_chunks_many(mons, states,
                                              chunk_indices=[1, 1, 1])
    out_seq = [m.update(s, chunk_index=1) for m, s in zip(seq, states)]
    for mb, ms in zip(mons, seq):
        np.testing.assert_allclose(mb._pos, ms._pos, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(mb._neg, ms._neg, rtol=1e-5, atol=1e-5)
        assert mb.n_scored == ms.n_scored == 1
    assert [len(a) for a in out_batch] == [len(a) for a in out_seq]
    assert monitor_lib.score_chunks_many([], []) == []


def test_cadence_coasts_when_stable_and_resets_on_alert():
    d, chunk, wc = 12, 100, 8
    br = simulate_var_breaks(m=6000, d=d, kind="noise_scale", seed=2,
                             at=3000)
    s = _session(d, chunk, wc, refit_every=2, coast_max=16)
    cadences = []
    n = (br.series.shape[0] // chunk) * chunk
    for start in range(0, n, chunk):
        if s.post(br.series[start:start + chunk]):
            s.refit_now()
        cadences.append((start + chunk > br.at, s.cadence))
    pre = [c for post, c in cadences if not post]
    post = [c for post, c in cadences if post]
    assert max(pre) == 16
    assert 2 in post
    assert any(a for a in s.alert_history)


def test_alert_makes_session_due_immediately():
    d, chunk, wc = 12, 100, 8
    br = simulate_var_breaks(m=6000, d=d, kind="noise_scale", seed=0,
                             at=3000)
    s = _session(d, chunk, wc, refit_every=4, coast_max=64)
    n = (br.series.shape[0] // chunk) * chunk
    for start in range(0, n, chunk):
        due = s.post(br.series[start:start + chunk])
        if s.pending_alerts:
            assert due
            break
        if due:
            s.refit_now()
    else:
        pytest.fail("no alert fired")
    delta = s.refit_now()
    assert delta.triggered_by == "alert" and delta.alerts
    assert delta.drift_score >= 1.0 and "drift" in delta.summary()


def test_unmonitored_session_fixed_cadence_unchanged():
    d, chunk, wc = 6, 64, 3
    s = StreamSession("s", StreamConfig(d=d, chunk=chunk, window_chunks=wc,
                                        fit=CFG, refit_every=2),
                      device="cpu")
    assert s.monitor is None
    x = simulate_var_stocks(m=chunk * (wc + 4) + 4, d=d, seed=3)[0]
    refits = 0
    for k in range(wc + 4):
        if s.post(x[k * chunk:(k + 1) * chunk]):
            s.refit_now()
            refits += 1
    assert refits == 2 and s.cadence == 2
    assert len(s.alert_history) == 0


@pytest.mark.parametrize("scores", [[2.0, 1.8, 0.2, 0.1],
                                    [0.0, 0.0, 0.0, 3.0],
                                    [0.5, 0.4, 2.2, 0.0]])
def test_drift_root_candidates_match_reference(scores):
    d = 4
    b0 = np.zeros((d, d), np.float32)
    b0[1, 0] = 0.9
    b0[2, 1] = 0.9
    order = np.array([0, 1, 2, 3])
    scores = np.array(scores, np.float32)
    got = rca.drift_root_candidates(torch.from_numpy(b0),
                                    torch.from_numpy(order), scores, top_k=3)
    want = jrca.drift_root_candidates(b0, order, scores, top_k=3)
    assert [v for v, _ in got] == [v for v, _ in want]
    np.testing.assert_allclose([s for _, s in got], [s for _, s in want])
    if scores[0] == 2.0:
        assert got[0][0] == 0  # the drifting ancestor ranks first


# ----------------------------------------------------------------------
# The data copy
# ----------------------------------------------------------------------


@pytest.mark.parametrize("kind", BREAK_KINDS)
@pytest.mark.parametrize("seed,d", [(0, 12), (3, 7)])
def test_simulate_var_breaks_copy_matches_reference(kind, seed, d):
    got = simulate_var_breaks(m=400, d=d, kind=kind, seed=seed, at=250)
    want = jsimulate.simulate_var_breaks(m=400, d=d, kind=kind, seed=seed,
                                         at=250)
    np.testing.assert_array_equal(got.series, want.series)
    assert (got.kind, got.at, got.variable) == (want.kind, want.at,
                                                 want.variable)
    for f in ("b0_pre", "b0_post", "m1"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert BREAK_KINDS == jsimulate.BREAK_KINDS
    with pytest.raises(ValueError):
        simulate_var_breaks(kind="nope")
