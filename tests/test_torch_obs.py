"""The port's telemetry (``repro_torch.obs``, ``repro_torch.analysis.
regress``) against the reference's ``tests/test_obs.py``, case for case,
and the copies pinned to their originals.

  * spans nest by host call stack, carry attributes, record errors and
    render as a tree; disabled telemetry returns a shared no-op; a span
    entered while ``torch.compile`` traces is tagged ``traced``;
  * metrics survive concurrent sessions and export snapshot / Prometheus
    text, exactly as the reference's copy does for the same calls;
  * instrumented and uninstrumented fits are bit-identical, and the
    compile log (kernel builds, tuning searches, mesh program shapes in
    the port) is queryable;
  * the serving engine, the streams, the monitor and the query engine
    record the reference's series names;
  * ``regress`` flags out-of-tolerance slowdowns over
    ``BENCH_torch_*.json`` and agrees with the reference's copy.
"""

import json
import threading
import time

import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.analysis import regress as jregress
from repro.obs import compile_log as jcompile_log
from repro.obs import metrics as jmetrics
from repro_torch import obs
from repro_torch.analysis import regress
from repro_torch.core import api, batched
from repro_torch.data.simulate import simulate_lingam
from repro_torch.obs import compile_log, metrics

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _clean_obs():
    for o in (obs, jobs):
        o.disable()
        o.reset_all()
    yield
    for o in (obs, jobs):
        o.disable()
        o.reset_all()


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------


def test_spans_nest_and_carry_attrs():
    obs.enable()
    with obs.span("outer", d=4) as outer:
        with obs.span("inner", step=1):
            pass
        with obs.span("inner", step=2) as s:
            s.set(variant="blocked")
    (root,) = obs.roots()
    assert root is outer
    assert root.attrs == {"d": 4}
    assert [c.name for c in root.children] == ["inner", "inner"]
    assert root.children[1].attrs == {"step": 2, "variant": "blocked"}
    assert root.duration_s >= max(c.duration_s for c in root.children)
    tree = obs.format_tree()
    assert "outer" in tree and "{step=2, variant=blocked}" in tree


def test_span_records_error_and_unwinds_stack():
    obs.enable()
    with pytest.raises(ValueError):
        with obs.span("boom"):
            raise ValueError("nope")
    (root,) = obs.roots()
    assert root.attrs["error"] == "ValueError"
    with obs.span("after"):
        pass
    assert [r.name for r in obs.roots()] == ["boom", "after"]  # not nested


def test_disabled_telemetry_is_noop():
    assert not obs.enabled()
    s = obs.span("x", d=1)
    assert s is obs.span("y")  # the shared no-op singleton
    with s:
        metrics.inc("c")
        metrics.observe("h", 1.0)
        metrics.gauge("g", 2.0)
    assert obs.roots() == []
    snap = metrics.snapshot()
    assert snap == {"counters": {}, "gauges": {}, "histograms": {}}
    assert obs.format_tree() == "(no spans recorded)"


def test_spans_feed_latency_histograms():
    obs.enable()
    with obs.span("stage"):
        pass
    h = metrics.snapshot()["histograms"]["span.stage_s"]
    assert h["count"] == 1 and h["max"] >= 0.0


def test_port_switch_is_its_own():
    """REPRO_TORCH_OBS / obs.enable switch the port alone: the reference's
    telemetry stays off, and the other way round."""
    obs.enable()
    assert obs.enabled() and not jobs.enabled()
    obs.disable()
    jobs.enable()
    assert jobs.enabled() and not obs.enabled()


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------


def test_metric_series_keyed_by_labels():
    obs.enable()
    metrics.inc("q", 2, kind="effects")
    metrics.inc("q", 3, kind="rca")
    metrics.inc("q", kind="effects")
    metrics.gauge("stale", 4, sid="s0")
    for v in (0.1, 0.2, 0.3, 0.4):
        metrics.observe("lat_s", v, d=8)
    snap = metrics.snapshot()
    assert snap["counters"]['q{kind="effects"}'] == 3.0
    assert snap["counters"]['q{kind="rca"}'] == 3.0
    assert snap["gauges"]['stale{sid="s0"}'] == 4.0
    h = snap["histograms"]['lat_s{d="8"}']
    assert h["count"] == 4 and h["max"] == 0.4
    assert abs(h["sum"] - 1.0) < 1e-12
    assert 0.1 <= h["p50"] <= h["p95"] <= h["p99"] <= 0.4


def test_metrics_copy_matches_reference():
    """The same calls give the same snapshot and, up to the package name
    in the HELP lines, the same Prometheus text as the reference's."""
    obs.enable()
    jobs.enable()
    rng = np.random.default_rng(0)
    for mod in (metrics, jmetrics):
        mod.inc("serve.requests", 5, kind="fit")
        mod.inc("serve.flush_errors", 1, error='shape ("x", 2)\nbad \\ x')
        mod.gauge("stream.staleness_chunks", 2, sid="s0")
    # more than the reservoir (2048), so the ring overwrite is exercised
    for v in rng.random(3000):
        metrics.observe("serve.flush_s", float(v), d=6)
        jmetrics.observe("serve.flush_s", float(v), d=6)
    assert metrics.snapshot() == jmetrics.snapshot()
    assert metrics.to_prometheus_text() == jmetrics.to_prometheus_text(
    ).replace(" repro.obs ", " repro_torch.obs ")


def test_metrics_stable_under_concurrent_sessions():
    """A thread storm of counter/histogram/span traffic loses nothing:
    counter totals are exact and snapshots taken mid-storm never see
    torn state."""
    obs.enable()
    n_threads, n_iter = 8, 300
    errs = []

    def session(tid):
        try:
            for i in range(n_iter):
                with obs.span("sess.step", tid=tid):
                    metrics.inc("sess.requests", sid=f"s{tid}")
                    metrics.observe("sess.lat_s", i * 1e-6)
                if i % 50 == 0:
                    snap = metrics.snapshot()
                    assert set(snap) == {"counters", "gauges", "histograms"}
        except Exception as e:  # pragma: no cover - failure path
            errs.append(e)

    threads = [
        threading.Thread(target=session, args=(t,)) for t in range(n_threads)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert not errs
    snap = metrics.snapshot()
    per_sid = [snap["counters"][f'sess.requests{{sid="s{t}"}}']
               for t in range(n_threads)]
    assert per_sid == [float(n_iter)] * n_threads
    assert snap["histograms"]["sess.lat_s"]["count"] == n_threads * n_iter
    # Every thread's roots landed (each thread has its own span stack).
    assert sum(r.name == "sess.step" for r in obs.roots()) == min(
        n_threads * n_iter, 256
    )


def test_prometheus_text_format():
    obs.enable()
    metrics.inc("serve.requests", 5, kind="fit")
    metrics.gauge("stream.staleness_chunks", 2, sid="s0")
    metrics.observe("serve.flush_s", 0.25)
    text = metrics.to_prometheus_text()
    assert 'serve_requests_total{kind="fit"} 5.0' in text
    assert 'stream_staleness_chunks{sid="s0"} 2.0' in text
    assert "serve_flush_s_count 1" in text
    assert "serve_flush_s_p99 0.25" in text
    assert text.endswith("\n")


def test_prometheus_help_type_headers_once_per_family():
    obs.enable()
    metrics.inc("serve.requests", 2, kind="fit")
    metrics.inc("serve.requests", 3, kind="flush")
    metrics.gauge("stream.cadence_chunks", 8, sid="s0")
    text = metrics.to_prometheus_text()
    assert text.count("# TYPE serve_requests_total counter") == 1
    assert text.count("# HELP serve_requests_total ") == 1
    assert text.count("# TYPE stream_cadence_chunks gauge") == 1
    lines = text.splitlines()
    # Headers precede their family's sample lines.
    t = lines.index("# TYPE serve_requests_total counter")
    assert lines[t + 1].startswith("serve_requests_total{")
    assert lines[t + 2].startswith("serve_requests_total{")


def test_prometheus_escapes_label_values():
    obs.enable()
    metrics.inc("serve.flush_errors", 1,
                error='shape ("x", 2)\nmismatch \\ bad')
    text = metrics.to_prometheus_text()
    assert (
        r'serve_flush_errors_total{error="shape (\"x\", 2)\n'
        r'mismatch \\ bad"} 1.0' in text
    )
    assert "\nmismatch" not in text  # no raw newline inside a sample


def test_chrome_trace_events():
    obs.enable()
    with obs.span("serve.flush", n_due=3):
        with obs.span("serve.flush_bucket", shape=(6, 6)):
            time.sleep(0.002)
    doc = obs.to_chrome_trace()
    assert doc["displayTimeUnit"] == "ms"
    by_name = {e["name"]: e for e in doc["traceEvents"]}
    assert set(by_name) == {"serve.flush", "serve.flush_bucket"}
    outer, inner = by_name["serve.flush"], by_name["serve.flush_bucket"]
    for e in (outer, inner):
        assert e["ph"] == "X"
        assert e["cat"] == "host"
        assert e["pid"] == 0 and e["tid"] == 0
    # Child nests inside the parent on the timeline, timestamps rebased
    # to the earliest root.
    assert outer["ts"] == 0.0
    assert inner["ts"] >= outer["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"] + 1.0
    assert inner["args"] == {"shape": "(6, 6)"}  # attrs stringified


def test_write_chrome_trace_roundtrip(tmp_path):
    obs.enable()
    with obs.span("fit", d=4):
        pass
    path = obs.write_chrome_trace(str(tmp_path / "trace.json"))
    with open(path) as f:
        doc = json.load(f)
    assert doc["traceEvents"][0]["name"] == "fit"


# ---------------------------------------------------------------------------
# BoundedRing
# ---------------------------------------------------------------------------


def test_bounded_ring_caps_and_counts_drops():
    ring = obs.BoundedRing(3)
    for i in range(5):
        ring.append(i)
    assert list(ring) == [2, 3, 4]  # oldest evicted first
    assert len(ring) == 3
    assert ring.dropped == 2
    assert ring[0] == 2 and ring[-1] == 4
    assert ring[1:] == [3, 4]
    assert bool(ring)
    ring.clear()
    assert not ring and ring.dropped == 0


def test_bounded_ring_drain_empties_oldest_first():
    ring = obs.BoundedRing(8)
    ring.extend("abc")
    assert ring.drain() == ["a", "b", "c"]
    assert ring.drain() == []
    assert not ring


def test_bounded_ring_rejects_nonpositive_capacity():
    with pytest.raises(ValueError):
        obs.BoundedRing(0)


# ---------------------------------------------------------------------------
# bit-identical results, spans while capturing, bounded cost
# ---------------------------------------------------------------------------

_CFG = api.FitConfig(backend="blocked", compaction="staged")


def _x(m, d, seed):
    gt = simulate_lingam(m=m, d=d, seed=seed)
    return torch.as_tensor(np.ascontiguousarray(gt.data, np.float32))


def test_instrumented_fit_bit_identical_and_no_rebuild():
    """Telemetry on changes no bit of a fit and builds or searches
    nothing new (the port's compile events)."""
    x = _x(400, 7, 42)
    r_off = api.fit_fn(x, _CFG)
    n_off = compile_log.total()
    obs.enable()
    r_on = api.fit_fn(x, _CFG)
    assert compile_log.total() == n_off
    for a, b in zip(r_off.to_numpy(), r_on.to_numpy()):
        np.testing.assert_array_equal(a, b)
    tree = obs.format_tree()
    for name in ("fit.local", "fit.ordering", "fit.pruning"):
        assert name in tree
    assert "[trace]" not in tree  # an eager fit runs, it is not captured


def test_dispatch_span_and_counter():
    """Each launch-plan decision is a ``kernels.dispatch`` span with its
    plan, and a counter by variant and source; off, neither."""
    from repro_torch.kernels.tune import registry

    registry.dispatch("pairwise_moments", (256, 8), mode="off",
                      device="cpu")
    assert obs.roots() == []
    obs.enable()
    plan = registry.dispatch("pairwise_moments", (256, 8), mode="off",
                             device="cpu")
    (root,) = obs.roots()
    assert root.name == "kernels.dispatch"
    assert root.attrs["tile"] == plan.tile
    assert root.attrs["source"] == "heuristic"
    key = ('kernels.dispatch{backend="cuda",op="pairwise_moments",'
           f'source="heuristic",variant="{plan.variant}"}}')
    assert metrics.snapshot()["counters"][key] == 1.0


def test_span_inside_torch_compile_is_tagged_traced():
    """A span entered while ``torch.compile`` traces is tagged
    ``traced=True`` (the reference's jax-0.9 trace-state check never
    tags), and the compiled function's result is the eager one's."""
    obs.enable()

    def body(x):
        with obs.span("compiled.body", n=x.shape[0]):
            return torch.tanh(x) * 2.0

    x = torch.linspace(-2.0, 2.0, 16)
    want = body(x)
    got = torch.compile(body, backend="eager", fullgraph=False)(x)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    traced = [r for r in obs.roots() if r.name == "compiled.body"]
    assert [r.traced for r in traced][0] is False  # the eager call
    assert any(r.traced for r in traced[1:])
    assert "[trace]" in obs.format_tree()
    cats = {e["cat"] for e in obs.to_chrome_trace()["traceEvents"]}
    assert cats == {"host", "capture"}


def test_enabled_overhead_under_two_percent():
    """Bound enabled-telemetry cost against the bootstrap workload: one
    batched fit through the serving path issues < 25 span/metric
    primitives; 25 of them must cost under 2% of the fit (a primitive
    cost bound, not a wall-clock A/B of two runs)."""
    x = _x(500, 8, 3)
    idx = torch.as_tensor(np.random.default_rng(0).integers(
        0, 500, size=(16, 500)))
    batched.bootstrap_fits(x, idx, _CFG)  # warm
    t_fit = min(_timed(lambda: batched.bootstrap_fits(x, idx, _CFG))
                for _ in range(3))

    obs.enable()
    n = 1000
    t0 = time.perf_counter()
    for i in range(n):
        with obs.span("overhead.probe", i=i):
            metrics.inc("overhead.calls")
            metrics.observe("overhead.val_s", 1e-6)
    per_probe = (time.perf_counter() - t0) / n
    assert per_probe * 25 < 0.02 * t_fit, (
        f"telemetry primitive cost {per_probe * 1e6:.1f}us/probe too high "
        f"vs fit {t_fit * 1e3:.1f}ms"
    )


def _timed(fn):
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


# ---------------------------------------------------------------------------
# call sites: the reference's series names
# ---------------------------------------------------------------------------


def _drive_engine(engine_mod, query_mod, session_mod, monitor_mod, **kw):
    rng = np.random.default_rng(0)
    eng = engine_mod.CausalDiscoveryEngine(batch_size=4, **kw)
    eng.run([engine_mod.FitRequest(
        data=rng.normal(size=(256, 6)).astype(np.float32))
        for _ in range(3)])
    sid = eng.open_stream(session_mod.StreamConfig(
        d=5, chunk=32, window_chunks=3, refit_every=1,
        monitor=monitor_mod.MonitorConfig(threshold=0.5, min_count=8)))
    for k in range(8):
        rows = rng.normal(size=(32, 5)).astype(np.float32)
        if k >= 5:
            rows[:, 2] *= 8.0  # a noise-scale break: alerts fire
        eng.post_chunk(sid, rows)
    eng.flush_streams()
    eng.poll_alerts()
    eng.query([query_mod.EffectQuery(graph=sid),
               query_mod.InterventionQuery(graph=sid, do={0: 1.5})])


def _series(snap, prefixes):
    out = set()
    for kind in ("counters", "gauges", "histograms"):
        for key in snap[kind]:
            name = key.split("{")[0]
            if name.startswith(prefixes):
                out.add((kind, name))
    return out


def test_call_sites_record_the_reference_series():
    """The same serving traffic through both engines, telemetry on,
    records the same serve.*, stream.*, monitor.* and query.* series."""
    from repro.infer import query as jquery
    from repro.serve import engine as jengine
    from repro.stream import monitor as jmonitor
    from repro.stream import session as jsession
    from repro_torch.infer import query
    from repro_torch.serve import engine
    from repro_torch.stream import monitor, session

    prefixes = ("serve.", "stream.", "monitor.", "query.", "span.serve.",
                "span.query.")
    jobs.enable()
    _drive_engine(jengine, jquery, jsession, jmonitor)
    want = _series(jmetrics.snapshot(), prefixes)
    jobs.disable()
    obs.enable()
    _drive_engine(engine, query, session, monitor, device="cpu")
    got = _series(metrics.snapshot(), prefixes)
    assert want, "the reference recorded nothing"
    assert got == want, (sorted(want - got), sorted(got - want))
    snap = metrics.snapshot()
    assert snap["counters"]["serve.fit_requests"] == 3.0


def test_call_sites_cost_nothing_when_off():
    """Telemetry off: the same traffic records no series and no span."""
    from repro_torch.infer import query
    from repro_torch.serve import engine
    from repro_torch.stream import monitor, session

    _drive_engine(engine, query, session, monitor, device="cpu")
    assert metrics.snapshot() == {"counters": {}, "gauges": {},
                                  "histograms": {}}
    assert obs.roots() == []


# ---------------------------------------------------------------------------
# spans inside the port: the refit from moments, the stream's stages, the
# moment-kernel computation, the ordering step's phases; the profiler's clock
# ---------------------------------------------------------------------------


def _walk(span, parents=()):
    """(span, names of its ancestors) over a span tree, depth first."""
    yield span, parents
    for c in span.children:
        yield from _walk(c, parents + (span.name,))


def _all_spans():
    return [sp for r in obs.roots() for sp in _walk(r)]


def _names_under(ancestor):
    return [s.name for s, up in _all_spans() if ancestor in up]


def _stats(x):
    mean = x.mean(dim=-2)
    xc = x - mean[..., None, :]
    return mean, xc.mT @ xc / x.shape[-2]


@pytest.mark.parametrize("batch", [False, True])
def test_fit_from_stats_records_ordering_and_pruning(batch):
    x = _x(300, 6, 5)
    if batch:
        x = torch.stack([x, _x(300, 6, 6)])
    mean, cov = _stats(x)
    cfg = api.FitConfig(compaction="staged")  # the kernel's plain version
    obs.enable()
    if batch:
        batched.fit_many_from_stats(x, mean, cov, cfg)
    else:
        api.fit_from_stats(x, mean, cov, cfg)
    roots = obs.roots()
    assert [r.name for r in roots] == ["fit.ordering", "fit.pruning"]
    assert roots[0].attrs == {"d": 6}
    assert roots[1].attrs == {"method": "ols"}
    assert _names_under("fit.ordering").count("kernels.moments") == 5


def _engine_traffic(n_sessions=2, posts=4):
    from repro_torch.serve import engine
    from repro_torch.stream import session

    rng = np.random.default_rng(1)
    eng = engine.CausalDiscoveryEngine(batch_size=n_sessions, device="cpu")
    sids = [eng.open_stream(session.StreamConfig(
        d=5, chunk=32, window_chunks=3, refit_every=1))
        for _ in range(n_sessions)]
    for _ in range(posts):
        for sid in sids:
            eng.post_chunk(sid, rng.normal(size=(32, 5)).astype(np.float32))
    eng.flush_streams()
    return sids


def test_engine_records_the_stream_stages():
    """Each post is one ``stream.absorb``; each session refitted in a
    flush is one ``stream.prepare`` and one ``stream.finish`` under
    ``serve.flush``, and the batched refit's ordering and pruning sit
    under ``serve.flush_bucket``."""
    obs.enable()
    sids = _engine_traffic(n_sessions=2, posts=4)
    spans = _all_spans()
    absorbs = [s for s, up in spans if s.name == "stream.absorb"]
    assert len(absorbs) == 8
    assert all(not up for s, up in spans if s.name == "stream.absorb")
    assert {s.attrs["sid"] for s in absorbs} == set(sids)
    assert {s.attrs["rows"] for s in absorbs} == {32}
    flushes = [r for r in obs.roots() if r.name == "serve.flush"]
    refits = sum(r.attrs["n_due"] for r in flushes)
    assert refits == 4   # the window fills at the third post: 2 slides x 2
    for name in ("stream.prepare", "stream.finish"):
        got = [s for s, up in spans if s.name == name]
        assert len(got) == refits
        assert all("serve.flush" in up for s, up in spans if s.name == name)
        assert {s.attrs["sid"] for s in got} == set(sids)
    for name in ("fit.ordering", "fit.pruning", "stream.finish"):
        assert all("serve.flush_bucket" in up for s, up in spans
                   if s.name == name)
    buckets = [s for s, _ in spans if s.name == "serve.flush_bucket"]
    assert [[c.name for c in b.children if c.name.startswith("fit.")]
            for b in buckets] == [["fit.ordering", "fit.pruning"]] * len(
                buckets)


def test_var_fit_records_the_var_estimate():
    from repro_torch.core.var_lingam import VarLiNGAM

    x = np.random.default_rng(2).normal(size=(200, 4)).astype(np.float32)
    obs.enable()
    VarLiNGAM(lags=1, device="cpu").fit(x)
    assert [r.name for r in obs.roots()] == ["var.estimate", "fit.local"]
    assert obs.roots()[0].attrs == {"lags": 1}


@pytest.mark.parametrize("method", ["ols", "adaptive_lasso"])
def test_pruning_records_its_solve_and_sweeps(method):
    """Inside ``fit.pruning``, the least-squares solve is one
    ``prune.ols`` span (d, the rows solved, the bytes of its systems: a
    float32 (rows, d, d) stack for OLS, the float64 (d, d) correlation the
    adaptive lasso factors) and the adaptive lasso's FISTA sweeps one
    ``prune.lasso`` span (iterations, rows, the correlation's bytes); the
    counters add up the systems and the iterations. Off, neither is
    recorded."""
    d, steps = 6, 37
    cfg = api.FitConfig(prune_method=method,
                        prune_kwargs={"lam": 0.05, "n_steps": steps}
                        if method == "adaptive_lasso" else {})
    x = _x(300, d, 10)
    api.fit_fn(x, cfg)
    assert obs.roots() == [] and metrics.snapshot()["counters"] == {}
    obs.enable()
    api.fit_fn(x, cfg)
    (pruning_span,) = [s for s, _ in _all_spans() if s.name == "fit.pruning"]
    names = [c.name for c in pruning_span.children]
    lasso = method == "adaptive_lasso"
    assert names == (["prune.ols", "prune.lasso"] if lasso
                     else ["prune.ols"])
    assert pruning_span.children[0].attrs == {
        "d": d, "rows": d,
        "system_bytes": d * d * 8 if lasso else d * d * d * 4}
    counters = metrics.snapshot()["counters"]
    assert counters["prune.systems"] == d
    if lasso:
        assert pruning_span.children[1].attrs == {
            "iterations": steps, "rows": d, "system_bytes": d * d * 8}
        assert counters["prune.lasso_iterations"] == steps
    else:
        assert "prune.lasso_iterations" not in counters
    assert not [n for n in _names_under("fit.ordering")
                if n.startswith("prune.")]


@pytest.mark.parametrize("compaction", ["none", "staged"])
def test_ordering_step_phases(compaction):
    """Each step is ``order.standardize``, ``kernels.moments``,
    ``order.scores``, ``order.residualize`` in that order: under
    ``fit.ordering`` the local plan's d - 1 steps, whatever
    ``compaction`` is; the mesh plan's schedule (here on the local
    reducer) takes d steps, and the staged one adds one ``order.compact``
    per stage that keeps columns."""
    from repro_torch.core import ordering

    d = 6
    cfg = api.FitConfig(compaction=compaction, min_stage=2)
    x = _x(300, d, 7)
    obs.enable()
    api.fit_fn(x, cfg)
    (ordering_span,) = [s for s, _ in _all_spans()
                        if s.name == "fit.ordering"]
    step = ["order.standardize", "kernels.moments", "order.scores",
            "order.residualize"]
    assert [c.name for c in ordering_span.children] == step * (d - 1)
    obs.reset_all()
    red = ordering.LocalReducer()
    if compaction == "staged":
        ordering.compact_order_impl(x, red, frac=cfg.compaction_frac,
                                    min_stage=cfg.min_stage)
    else:
        ordering.full_width_order_impl(x, red)
    names = [r.name for r in obs.roots()]
    assert [n for n in names if n != "order.compact"] == step * d
    stages = ordering._stage_schedule(d, cfg.compaction_frac,
                                      cfg.min_stage)
    keeping = sum(1 for w, n in stages if w - n) if compaction == "staged" \
        else 0
    assert names.count("order.compact") == keeping
    if keeping:
        assert keeping == len(stages) - 1 and keeping >= 2
        # a stage's gather follows its last step
        assert names[4 * stages[0][1]] == "order.compact"


@pytest.mark.parametrize("plan", ["local", "mesh"])
def test_cpu_ordering_steps_take_the_composed_passes(plan):
    """On the CPU the local plan (d - 1 steps) and the mesh plan (d steps,
    a 1 x 1 mesh in this process) run the step's composed passes: every
    ``order.standardize`` span carries ``path="composed"`` and no
    step-pass kernel is called."""
    from repro_torch.kernels import step_passes

    d = 5
    part = (api.Partition(mesh=(("data", 1), ("model", 1)), chunk=64)
            if plan == "mesh" else None)
    before = (step_passes.launches, step_passes.residualize_launches)
    obs.enable()
    api.fit_fn(_x(300, d, 9), api.FitConfig(partition=part))
    paths = [s.attrs.get("path") for s, _ in _all_spans()
             if s.name == "order.standardize"]
    assert paths == ["composed"] * (d if plan == "mesh" else d - 1)
    assert (step_passes.launches,
            step_passes.residualize_launches) == before


@pytest.mark.parametrize("op", ["pairwise_moments",
                                "pairwise_moment_sums_rows",
                                "pairwise_moment_sums_slabs"])
def test_moment_span_carries_op_and_shape(op):
    from repro_torch.kernels import pairwise_stats

    x = _x(300, 5, 8)
    x_std = (x - x.mean(0)) / x.std(0, unbiased=False)
    c = x_std.T @ x_std / x.shape[0]
    call = {
        "pairwise_moments": lambda: pairwise_stats.pairwise_moments(
            x_std, c),
        "pairwise_moment_sums_rows": lambda: (
            pairwise_stats.pairwise_moment_sums_rows(x_std, c, 1, 3)),
        "pairwise_moment_sums_slabs": lambda: (
            pairwise_stats.pairwise_moment_sums_slabs(x_std, c, 128)),
    }[op]
    want = call()
    obs.enable()
    got = call()
    for a, b in zip(want, got):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    (root,) = obs.roots()
    assert root.name == "kernels.moments"
    rows = 3 if op == "pairwise_moment_sums_rows" else 5
    assert root.attrs == {"op": op, "shape": (1, 300, 5), "rows": rows,
                          "tile": None}
    assert root.children == []


def _fit_path(path):
    from repro_torch.core.var_lingam import VarLiNGAM

    x = _x(300, 5, 9)
    if path == "fit":
        api.fit_fn(x, api.FitConfig(compaction="staged", min_stage=2))
    elif path == "stats":
        api.fit_from_stats(x, *_stats(x), _CFG)
    elif path == "batched_stats":
        xs = torch.stack([x, x.flip(0)])
        batched.fit_many_from_stats(xs, *_stats(xs), _CFG)
    elif path == "var":
        VarLiNGAM(lags=1, device="cpu").fit(x.numpy())
    else:
        _engine_traffic()


@pytest.mark.parametrize("path", ["fit", "stats", "batched_stats", "var",
                                  "stream"])
def test_inner_spans_cost_nothing_when_off(path):
    """Telemetry off: the fit, stats, VAR and stream paths record no span
    and no series; on, the same path records its spans."""
    _fit_path(path)
    assert obs.roots() == []
    assert metrics.snapshot() == {"counters": {}, "gauges": {},
                                  "histograms": {}}
    obs.enable()
    _fit_path(path)
    assert obs.roots()


def test_span_starts_lie_on_the_profilers_clock():
    """Spans exported by ``to_chrome_trace`` lay over the profiler's
    ranges: ``baseTimeNanoseconds + ts * 1e3`` is within 1 ms of each
    mirrored range's start, and the durations agree within 1 ms. The
    window opens with a range of its own, as a traced run's does (the
    first range of a process takes its set-up time)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.obs import trace

    obs.enable()
    trace.set_annotation_hook(record_function)
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof, \
                record_function("clock.window"):
            with obs.span("clock.outer", k=1):
                for i in range(3):
                    with obs.span(f"clock.inner{i}"):
                        time.sleep(0.002)
                        with obs.span(f"clock.leaf{i}"):
                            time.sleep(0.001)
    finally:
        trace.set_annotation_hook(None)
    doc = obs.to_chrome_trace()
    base = doc["baseTimeNanoseconds"]
    assert abs(base - time.time_ns()) < 60e9   # the Unix-epoch clock
    spans = {e["name"]: e for e in doc["traceEvents"]}
    ranges = {e.name(): e for e in prof.profiler.kineto_results.events()
              if e.name() in spans}
    assert set(ranges) == set(spans) and len(spans) == 7
    for name, e in spans.items():
        r = ranges[name]
        assert abs(base + e["ts"] * 1e3 - r.start_ns()) < 1e6, name
        assert abs(e["dur"] * 1e3 - r.duration_ns()) < 1e6, name


def test_device_trace_writes_the_windows_spans(tmp_path):
    """``profile.device_trace`` writes the profiler's trace and the spans
    of its window, both with a ``baseTimeNanoseconds`` on one clock."""
    from repro_torch.obs import profile

    obs.enable()
    with obs.span("before.window"):
        pass
    profile.enable()
    try:
        with profile.device_trace(str(tmp_path)):
            with obs.span("in.window", d=3):
                time.sleep(0.001)
    finally:
        profile.disable()
    with open(tmp_path / "spans.json") as f:
        doc = json.load(f)
    assert [e["name"] for e in doc["traceEvents"]] == ["in.window"]
    assert doc["traceEvents"][0]["args"] == {"d": "3"}
    with open(tmp_path / "device_trace.json") as f:
        prof_doc = json.load(f)
    (mirror,) = [e for e in prof_doc["traceEvents"]
                 if e.get("name") == "in.window" and e.get("ph") == "X"]
    start = doc["baseTimeNanoseconds"] + doc["traceEvents"][0]["ts"] * 1e3
    prof_start = (prof_doc.get("baseTimeNanoseconds", 0)
                  + float(mirror["ts"]) * 1e3)
    assert abs(start - prof_start) < 1e6


# ---------------------------------------------------------------------------
# compile log
# ---------------------------------------------------------------------------


def test_compile_log_keys_and_queries():
    compile_log.record("op.a", shape=(64, 5), config=_CFG, note="first")
    compile_log.record("op.a", shape=(64, 5), config=_CFG)
    compile_log.record("op.a", shape=(128, 5), config=_CFG)
    compile_log.record("op.b")
    key = ("op.a", (64, 5), compile_log.config_hash(_CFG))
    assert compile_log.counts("op.a")[key] == 2
    assert compile_log.total("op.a") == 3
    assert compile_log.by_op() == {"op.a": 3, "op.b": 1}
    assert [e["op"] for e in compile_log.events("op.b")] == ["op.b"]
    assert compile_log.events("op.a")[0]["note"] == "first"
    snap = compile_log.snapshot()
    assert snap["by_op"]["op.a"] == 3
    assert any(k.startswith("op.a:[64, 5]") for k in snap["by_signature"])
    # Distinct configs hash to distinct signatures.
    other = api.FitConfig(backend="blocked", prune_method="adaptive")
    assert compile_log.config_hash(other) != compile_log.config_hash(_CFG)
    assert compile_log.config_hash(None) == "-"
    # The copy keys events as the reference's does.
    for args in ((("op.a",), dict(shape=(64, 5), config=("k", 1))),
                 (("op.b",), dict())):
        jcompile_log.record(*args[0], **args[1])
    assert compile_log.config_hash(("k", 1)) == jcompile_log.config_hash(
        ("k", 1))
    assert set(jcompile_log.counts()) <= set(compile_log.counts()) | {
        ("op.a", (64, 5), jcompile_log.config_hash(("k", 1)))}


def test_compile_log_always_on_and_feeds_metrics_when_enabled():
    assert not obs.enabled()
    compile_log.record("op.silent", shape=(2,))
    assert compile_log.total("op.silent") == 1  # recorded while disabled
    assert metrics.snapshot()["counters"] == {}
    obs.enable()
    compile_log.record("op.loud")
    assert metrics.snapshot()["counters"]['compiles{op="op.loud"}'] == 1.0


def test_one_search_per_bucket(tmp_path, monkeypatch):
    """The port's counterpart of the reference's one-compile-per-bucket
    pins: a tuning search is logged once per bucket, and a second
    warm-up of the same shapes searches nothing (the table answers)."""
    from repro_torch.kernels.tune import autotune
    from repro_torch.kernels.tune import cache as tune_cache

    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(tmp_path / "t.json"))
    tune_cache.reset_table()
    try:
        shapes = [(300, 6), (500, 6)]  # one pairwise_moments bucket
        autotune.warmup_plans(shapes, mode="auto", device="cpu")
        n = compile_log.total("kernels.tune")
        assert n == 1
        autotune.warmup_plans(shapes, mode="auto", device="cpu")
        assert compile_log.total("kernels.tune") == n
    finally:
        tune_cache.reset_table()


# ---------------------------------------------------------------------------
# regression tracker
# ---------------------------------------------------------------------------


def _fake_artifact(scale=1.0):
    return {
        "bench": "speedup",
        "quick": True,
        "timestamp": "2026-01-01T00:00:00",
        "hardware": {"platform": "gpu", "kind": "card"},
        "rows": [{
            "cell": "m2000.d16", "m": 2000, "d": 16,
            "loop_s": 1.0 * scale, "vmap_s": 0.1 * scale,
            "vmap_fits_per_s": 100.0 / scale, "speedup": 10.0,
            "edge_prob_agree": 0.99,  # not a perf metric
        }],
    }


def test_collect_metrics_directions_and_labels():
    got = regress.collect_metrics(_fake_artifact())
    assert got["rows[cell=m2000.d16,m=2000,d=16].loop_s"] == ("lower", 1.0)
    assert got["rows[cell=m2000.d16,m=2000,d=16].vmap_fits_per_s"] == (
        "higher", 100.0
    )
    assert not any(m.endswith("edge_prob_agree") for m in got)
    # Time units normalize to seconds (ms/us suffixes).
    us = regress.collect_metrics({"rows": [{"op": "k", "tuned": {"us": 2.0}}]})
    assert us["rows[op=k].tuned.us"] == ("lower", 2e-6)
    # The copy extracts what the reference's does.
    assert regress.collect_metrics(_fake_artifact()) == \
        jregress.collect_metrics(_fake_artifact())


def test_compare_tolerance_band_and_floor():
    base = regress.collect_metrics(_fake_artifact(1.0))
    # 50% slower: beyond tol and the absolute floor -> regression.
    worse = {d.metric: d for d in regress.compare(
        base, regress.collect_metrics(_fake_artifact(1.5)),
        tol=0.25, min_abs=0.005,
    )}
    assert worse["rows[cell=m2000.d16,m=2000,d=16].loop_s"].status == \
        "REGRESSED"
    assert worse["rows[cell=m2000.d16,m=2000,d=16].vmap_fits_per_s"].status \
        == "REGRESSED"  # rate fell below the band
    # 10% slower: inside the band -> ok.
    ok = regress.compare(
        base, regress.collect_metrics(_fake_artifact(1.1)),
        tol=0.25, min_abs=0.005,
    )
    assert all(d.status == "ok" for d in ok)
    # Microsecond-scale jitter: relatively huge, absolutely tiny -> the
    # floor keeps it from failing a build.
    tiny_b = {"m.t_s": ("lower", 1e-4)}
    tiny_c = {"m.t_s": ("lower", 3e-4)}
    (d,) = regress.compare(tiny_b, tiny_c, tol=0.25, min_abs=0.005)
    assert d.status == "ok"
    (d,) = regress.compare(tiny_b, tiny_c, tol=0.25, min_abs=0.0)
    assert d.status == "REGRESSED"
    jworse = jregress.compare(
        base, regress.collect_metrics(_fake_artifact(1.5)),
        tol=0.25, min_abs=0.005)
    assert [(d.metric, d.status) for d in jworse] == [
        (d.metric, d.status) for d in worse.values()]


def test_compare_flags_new_and_missing_metrics():
    base = {"a_s": ("lower", 1.0)}
    cur = {"b_s": ("lower", 1.0)}
    by = {d.metric: d.status for d in regress.compare(
        base, cur, tol=0.25, min_abs=0.005
    )}
    assert by == {"a_s": "missing", "b_s": "new"}


def test_regress_cli_exit_codes(tmp_path, capsys):
    basedir, curdir = tmp_path / "base", tmp_path / "cur"
    basedir.mkdir(), curdir.mkdir()
    (basedir / "BENCH_torch_speedup.json").write_text(
        json.dumps(_fake_artifact(1.0))
    )
    (curdir / "BENCH_torch_speedup.json").write_text(
        json.dumps(_fake_artifact(2.0))
    )
    rc = regress.main([
        "--baseline-dir", str(basedir), "--current-dir", str(curdir),
        "--only", "speedup",
    ])
    assert rc == 1
    assert "REGRESSED" in capsys.readouterr().out
    # Same artifacts within tolerance -> success.
    (curdir / "BENCH_torch_speedup.json").write_text(
        json.dumps(_fake_artifact(1.05))
    )
    assert regress.main([
        "--baseline-dir", str(basedir), "--current-dir", str(curdir),
        "--only", "speedup",
    ]) == 0
    # Smoke mode self-compares the baselines.
    assert regress.main([
        "--baseline-dir", str(basedir), "--smoke", "--only", "speedup",
    ]) == 0
    # No baselines at all is an error.
    assert regress.main(["--baseline-dir", str(curdir / "nope")]) == 2


def test_regress_smoke_on_committed_artifacts():
    """The repo's own BENCH_torch_*.json artifacts parse and yield
    metrics."""
    assert regress.main(["--smoke"]) == 0


def test_provenance_shape():
    prov = obs.provenance(repo_root=str(regress._REPO_ROOT))
    for k in ("timestamp", "torch_version", "cuda_version", "device_kind",
              "platform", "git_sha"):
        assert k in prov
    assert "jax_version" not in prov
    assert prov["git_sha"] not in ("", None)
    assert prov["platform"] == ("gpu" if torch.cuda.is_available()
                                else "cpu")
