"""Closed loop of ``repro_torch.core.DirectLiNGAM().fit(X)`` at the facade's
defaults: one (m, d) dataset from the configuration's generator, handed
in as a row-major host array, the numpy result back on the host."""

from __future__ import annotations

import numpy as np

from lingambench.lib import judge, simulate


def setup(run):
    cfg = run.cell.config
    x, _, _ = simulate.simulate_lingam(cfg["m"], cfg["d"], seed=run.seed,
                                       **cfg["data"]["params"])
    state = {"x": np.ascontiguousarray(x), "device": run.device.type}
    if run.program:
        from repro_torch.core import DirectLiNGAM
        state["model"] = DirectLiNGAM
    return state


def _fit(state):
    return state["model"](device=state["device"]).fit(state["x"])


def warmup(state):
    _fit(state)


def run_op(state, k):
    model = _fit(state)
    return (model.causal_order_.copy(), model.adjacency_.copy(),
            model.resid_var_.copy())


def items_per_op(state):
    return 1


def shapes(state):
    m, d = state["x"].shape
    return [(m, d, 1)]


def release(state):
    state.pop("model", None)


def answers(state, records, rng):
    """One fit drawn from the seed: every fit of the window fits the same
    data."""
    if records is None:
        return [judge.Answer("direct", state["x"])]
    order, adjacency, resid_var = records[int(rng.integers(len(records)))]
    return [judge.Answer("direct", state["x"], order=order,
                         adjacency=adjacency, resid_var=resid_var)]
