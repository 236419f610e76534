"""Closed loop of the batched bootstrap
``repro_torch.core.batched.bootstrap_fits`` over the VAR(k) residuals of
one panel from the configuration's VAR generator.

The benchmark computes the residuals at set-up (float64 least squares,
handed in as float32 on the card) and draws ``index_sets`` sets of
``resamples`` row-resample indices from the seed on the card; call k
uses set k mod ``index_sets``. The fit config is the one
``bootstrap_lingam`` resolves for ``strategy="vmap"``, and each call
brings the (resamples, d, d) adjacency stack and the orders to the host.
"""

from __future__ import annotations

import numpy as np
import torch

from lingambench.lib import judge, reference, simulate


def setup(run):
    cfg, tr = run.cell.config, run.cell.traffic
    x, _, _ = simulate.simulate_var_stocks(cfg["m"], cfg["d"], seed=run.seed,
                                           **cfg["data"]["params"])
    _, _, resid = reference.var_lstsq(x, cfg["lags"])
    resid = np.ascontiguousarray(resid, dtype=np.float32)
    gen = torch.Generator(device=run.device)
    gen.manual_seed(run.seed)
    idx = torch.randint(0, resid.shape[0],
                        (tr["index_sets"], tr["resamples"], resid.shape[0]),
                        generator=gen, device=run.device)
    state = {"resid": resid, "idx": idx, "check": tr["check_resamples"]}
    if run.program:
        from repro_torch.core import batched, bootstrap

        state["x"] = torch.as_tensor(resid, device=run.device)
        state["config"] = bootstrap._resolve_config(None, None, None, "vmap")
        state["fits"] = batched.bootstrap_fits
    return state


def _call(state, k):
    s = k % state["idx"].shape[0]
    res = state["fits"](state["x"], state["idx"][s], state["config"])
    return s, res.order.cpu().numpy(), res.adjacency.cpu().numpy()


def warmup(state):
    _call(state, 0)


def run_op(state, k):
    return _call(state, k)


def items_per_op(state):
    return state["idx"].shape[1]


def shapes(state):
    m, d = state["resid"].shape
    return [(m, d, state["idx"].shape[1])]


def release(state):
    for key in ("x", "fits"):
        state.pop(key, None)


def answers(state, records, rng):
    """Every resample of one call drawn from the seed, each against its
    resampled residuals; the order replayed on ``check_resamples`` of
    them, also drawn from the seed."""
    call = None if records is None else records[int(rng.integers(
        len(records)))]
    s = 0 if call is None else call[0]
    n = state["idx"].shape[1]
    replay = set(rng.choice(n, size=min(n, state["check"]),
                            replace=False).tolist())
    rows = state["idx"][s].cpu().numpy()
    out = []
    for r in range(n):
        if call is None and r not in replay:
            continue
        a = judge.Answer("direct", state["resid"][rows[r]],
                         replay=r in replay)
        if call is not None:
            a.order, a.adjacency = call[1][r], call[2][r]
        out.append(a)
    return out
