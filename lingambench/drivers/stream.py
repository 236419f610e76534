"""Rolling VarLiNGAM sessions served by
``repro_torch.serve.engine.CausalDiscoveryEngine``, in a closed loop of
slides.

Each session replays a panel of its own, a stretch of one series from the
configuration's VAR generator, chunk by chunk (cycling back to the
panel's first chunk at its end). A slide posts every session its next
chunk and calls ``flush_streams()``; the engine refits all due sessions
as one batch (it flushes as soon as the last session's post makes a full
batch due) and every session's refreshed graph is brought to the host.
The monitor is off. The warm-up fills every window and makes one slide,
so the window runs at the steady (chunk x window_chunks)-row shape.
"""

from __future__ import annotations

import numpy as np

from lingambench.lib import judge, simulate


def setup(run):
    cfg, tr = run.cell.config, run.cell.traffic
    st = cfg["stream"]
    chunk, n_sess, n_chunks = st["chunk"], tr["sessions"], tr["panel_chunks"]
    rows = chunk * n_chunks
    x, _, _ = simulate.simulate_var_stocks(rows * n_sess, cfg["d"],
                                           seed=run.seed,
                                           **cfg["data"]["params"])
    state = {
        "panels": [np.ascontiguousarray(x[s * rows:(s + 1) * rows])
                   for s in range(n_sess)],
        "chunk": chunk, "window_chunks": st["window_chunks"],
        "lags": cfg["lags"], "n_chunks": n_chunks, "posts": 0,
        "check_sessions": tr["check_sessions"], "stale": 0,
    }
    if run.program:
        from repro_torch.serve.engine import CausalDiscoveryEngine
        from repro_torch.stream import StreamConfig

        engine = CausalDiscoveryEngine(batch_size=n_sess,
                                       device=run.device.type)
        sc = StreamConfig(d=cfg["d"], chunk=chunk,
                          window_chunks=st["window_chunks"],
                          lags=cfg["lags"], refit_every=st["refit_every"])
        state["engine"] = engine
        state["sids"] = [engine.open_stream(sc) for _ in range(n_sess)]
        state["graphs"] = [None] * n_sess
    return state


def _chunk(state, s, post):
    c = post % state["n_chunks"]
    return state["panels"][s][c * state["chunk"]:(c + 1) * state["chunk"]]


def _slide(state):
    eng, sids = state["engine"], state["sids"]
    before = [eng.stream_session(sid).n_refits for sid in sids]
    post = state["posts"]
    for s, sid in enumerate(sids):
        eng.post_chunk(sid, _chunk(state, s, post))
    eng.flush_streams()
    state["posts"] = post + 1
    for s, sid in enumerate(sids):
        sess = eng.stream_session(sid)
        if sess.rolling.ready and sess.n_refits == before[s]:
            state["stale"] += 1
        fit = sess.last_fit
        if fit is not None:
            state["graphs"][s] = (fit.result.order.cpu().numpy(),
                                  fit.thetas[0], fit.var_coefs[0])
    return post


def warmup(state):
    while state["posts"] <= state["window_chunks"]:
        _slide(state)
    state["stale"] = 0


def run_op(state, k):
    return _slide(state)


def items_per_op(state):
    return 1


def shapes(state):
    return [(state["chunk"] * state["window_chunks"],
             state["panels"][0].shape[1], len(state["panels"]))]


def release(state):
    state.pop("engine", None)


def window_rows(state, s, last_post):
    """The raw rows of session ``s``'s window after post ``last_post``:
    the lag rows before the window, then its chunks."""
    wc, lags = state["window_chunks"], state["lags"]
    chunks = [_chunk(state, s, p)
              for p in range(last_post - wc + 1, last_post + 1)]
    lead = _chunk(state, s, last_post - wc)[-lags:]
    return np.concatenate([lead] + chunks)


def answers(state, records, rng):
    """Every session's graph after the last slide, against its raw window;
    the order replayed for ``check_sessions`` sessions drawn from the
    seed."""
    n = len(state["panels"])
    replay = set(rng.choice(n, size=min(n, state["check_sessions"]),
                            replace=False).tolist())
    last = records[-1] if records else state["window_chunks"] + 8
    out = []
    for s in range(n):
        if records is None and s not in replay:
            continue
        a = judge.Answer("var", window_rows(state, s, last),
                         lags=state["lags"], replay=s in replay)
        if records is not None and state["graphs"][s] is not None:
            a.order, a.adjacency, a.var_coefs = state["graphs"][s]
        out.append(a)
    return out


def extra_numbers(state, records):
    """Slides in which a session with a full window was not refitted."""
    return {"stale_refits": float(state["stale"])}
