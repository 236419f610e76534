"""Rolling VarLiNGAM sessions with the graph-health monitor on, served by
``repro_torch.serve.engine.CausalDiscoveryEngine``: ``drivers/stream.py``'s
slides, with every session carrying a ``MonitorConfig`` (the traffic's
``monitor``: ``MonitorConfig``'s defaults) and every slide draining the
alerts through ``engine.poll_alerts()`` inside the timed slide.

Each post is scored against the graph the session served before it. The
monitor is re-armed at every refit and this traffic refits every session
every slide, so each post's CUSUM levels come from its own chunk alone.

The check keeps ``drivers/stream.py``'s numbers and adds the alerts users
receive, judged by ``lib/reference_monitor.py`` for one (session, post)
drawn from the seed, drawn again while it has no alert.
"""

from __future__ import annotations

import numpy as np

from lingambench.drivers import stream
from lingambench.lib import reference_monitor, runner

MAX_DRAWS = 64     # draws for a (session, post) that fired an alert


def setup(run):
    # stream.setup without the program makes the panels; the sessions
    # are opened here, each with its monitor.
    state = stream.setup(runner.Run(run.cell, run.seed, run.device,
                                    program=False))
    state.update(monitor=dict(run.cell.traffic["monitor"]), log=[],
                 seed=run.seed)
    if run.program:
        from repro_torch.serve.engine import CausalDiscoveryEngine
        from repro_torch.stream import MonitorConfig, StreamConfig

        cfg, st = run.cell.config, run.cell.config["stream"]
        engine = CausalDiscoveryEngine(batch_size=len(state["panels"]),
                                       device=run.device.type)
        sc = StreamConfig(d=cfg["d"], chunk=st["chunk"],
                          window_chunks=st["window_chunks"],
                          lags=cfg["lags"], refit_every=st["refit_every"],
                          monitor=MonitorConfig(**state["monitor"]))
        state["engine"] = engine
        state["sids"] = [engine.open_stream(sc) for _ in state["panels"]]
        state["graphs"] = [None] * len(state["panels"])
    return state


def _slide(state):
    """One slide of ``stream``'s, then the alerts drained; the log keeps
    each session's served graph (a reference, no copy) and the alerts."""
    eng = state["engine"]
    post = state["posts"]
    served = [eng.stream_session(sid).monitor.graph for sid in state["sids"]]
    stream._slide(state)
    state["log"].append((post, served, eng.poll_alerts()))
    return post


def _dropped(state):
    """Alerts the sessions' unread rings have evicted so far."""
    eng = state["engine"]
    return sum(eng.stream_session(sid).unread_alerts.dropped
               for sid in state["sids"])


def warmup(state):
    while state["posts"] <= state["window_chunks"]:
        _slide(state)
    state["stale"] = 0
    state["log"].clear()
    state["dropped"] = _dropped(state)


def run_op(state, k):
    return _slide(state)


items_per_op = stream.items_per_op
shapes = stream.shapes
answers = stream.answers


def release(state):
    state["dropped"] = _dropped(state) - state["dropped"]
    state.pop("engine", None)


def _alerts_of(state, k, s):
    _, _, alerts = state["log"][k]
    return [a for a in alerts if a.sid == state["sids"][s]]


def drawn_alerts(state):
    """(raw rows, served graph, alerts as (kind, variable, stat)) of one
    (slide of the window, session) drawn from the seed: the first of
    ``MAX_DRAWS`` draws whose post fired an alert, else the last draw."""
    rng = runner.rng_for(state["seed"], 3)
    for _ in range(MAX_DRAWS):
        k = int(rng.integers(len(state["log"])))
        s = int(rng.integers(len(state["panels"])))
        alerts = _alerts_of(state, k, s)
        if alerts:
            break
    post, served, _ = state["log"][k]
    g = served[s]
    graph = {"a": g.a, "intercept": g.intercept, "b0": g.b0,
             "resid_var": g.resid_var}
    lags = state["lags"]
    rows = np.concatenate([stream._chunk(state, s, post - 1)[-lags:],
                           stream._chunk(state, s, post)])
    return rows, graph, [(a.kind, a.variable, a.stat) for a in alerts]


def extra_numbers(state, records):
    """``stale_refits``, and ``monitor_z_err`` and ``monitor_alert_diff``
    of the drawn post's alerts; beside them, not compared, the alerts
    fired and delivered a slide (the rings keep the newest
    ``max_pending`` of a session's) and those delivered at the drawn
    post."""
    rows, graph, delivered = drawn_alerts(state)
    log = state["log"]
    delivered_all = sum(len(a) for _, _, a in log)
    return {**stream.extra_numbers(state, records),
            **reference_monitor.judge(rows, state["lags"], graph,
                                      delivered, state["monitor"]),
            "alerts_fired_per_slide": (delivered_all + state["dropped"])
            / len(log),
            "alerts_per_slide": delivered_all / len(log),
            "drawn_alerts": float(len(delivered))}
