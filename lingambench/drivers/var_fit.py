"""Closed loop of ``repro_torch.core.VarLiNGAM(lags=k).fit(X)`` on one (m, d)
panel from the configuration's VAR generator, handed in as a row-major
host array."""

from __future__ import annotations

import numpy as np

from lingambench.lib import judge, simulate


def setup(run):
    cfg = run.cell.config
    x, _, _ = simulate.simulate_var_stocks(cfg["m"], cfg["d"], seed=run.seed,
                                           **cfg["data"]["params"])
    state = {"x": np.ascontiguousarray(x), "lags": cfg["lags"],
             "device": run.device.type}
    if run.program:
        from repro_torch.core import VarLiNGAM
        state["model"] = VarLiNGAM
    return state


def _fit(state):
    return state["model"](lags=state["lags"],
                          device=state["device"]).fit(state["x"])


def warmup(state):
    _fit(state)


def run_op(state, k):
    model = _fit(state)
    return (model.causal_order_.copy(), model.adjacency_matrices_[0].copy(),
            model.var_coefs_[0].copy())


def items_per_op(state):
    return 1


def shapes(state):
    m, d = state["x"].shape
    return [(m - state["lags"], d, 1)]


def release(state):
    state.pop("model", None)


def answers(state, records, rng):
    """One fit drawn from the seed: every fit of the window fits the same
    panel."""
    if records is None:
        return [judge.Answer("var", state["x"], lags=state["lags"])]
    order, b0, coefs = records[int(rng.integers(len(records)))]
    return [judge.Answer("var", state["x"], order=order, adjacency=b0,
                         var_coefs=coefs, lags=state["lags"])]
