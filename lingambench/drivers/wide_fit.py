"""Closed loop of ``repro_torch.core.DirectLiNGAM().fit(X)`` at the facade's
defaults on one wide (m, d) dataset from the configuration's generator,
handed in as a row-major float32 host array, the numpy result back on the
host.

The generic judge has nothing to judge here (``answers`` is empty): a
replay of the whole order costs about as many minutes as the fit costs
seconds. ``extra_numbers`` judges one fit of the window, drawn from the
seed, with ``lib/reference_wide.py``: the order at step 0 and at
``drawn_steps`` steps drawn from the seed, the adjacency and the residual
variances against least squares by QR for that order.
"""

from __future__ import annotations

import numpy as np

from lingambench.lib import reference_gene, reference_wide, runner, simulate


def setup(run):
    cfg = run.cell.config
    x, _, order = simulate.simulate_lingam(cfg["m"], cfg["d"], seed=run.seed,
                                           **cfg["data"]["params"])
    state = {"x": np.ascontiguousarray(x), "device": run.device,
             "seed": run.seed, "drawn": run.cell.traffic["drawn_steps"],
             "true_order": np.asarray(order)}
    if run.program:
        from repro_torch.core import DirectLiNGAM
        state["model"] = DirectLiNGAM
    return state


def _fit(state):
    return state["model"](device=state["device"].type).fit(state["x"])


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


def steps(state):
    """The steps the check scores: 0 and ``drawn_steps`` more from the
    seed."""
    return reference_gene.drawn_steps(state["x"].shape[1], state["drawn"],
                                      runner.rng_for(state["seed"], 2))


def answers(state, records, rng):
    return []


def extra_numbers(state, records):
    """``order_gap_drawn``, ``adjacency_err`` and ``resid_var_err`` of one
    fit of the window, drawn from the seed."""
    pick = int(runner.rng_for(state["seed"], 1).integers(len(records)))
    order, adjacency, resid_var = records[pick]
    return reference_wide.judge(state["x"], order, adjacency, resid_var,
                                steps(state), state["device"])
