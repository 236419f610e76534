"""Closed loop of the gene screen's fit: ``repro_torch.core.DirectLiNGAM``
with the estimator the configuration states (the adaptive lasso, staged
compaction), on one (m, d) screen from the frozen Perturb-seq-like
generator, handed in as a row-major float32 host array, the numpy result
back on the host.

The generic judge has nothing to judge here (``answers`` is empty): a
replay of the whole order at this size takes many minutes, and it knows
only least-squares adjacency. ``extra_numbers`` judges one fit of the
window, drawn from the seed, with ``lib/reference_gene.py``: the order at
step 0 and at ``drawn_steps`` steps drawn from the seed, and the
adjacency against the float64 adaptive lasso for that order.
"""

from __future__ import annotations

import numpy as np

from lingambench.lib import reference_gene, runner, simulate_gene


def setup(run):
    cfg = run.cell.config
    est = cfg["estimator"]
    x, _, _ = simulate_gene.simulate_gene_perturb(
        cfg["m"], cfg["d"], seed=run.seed, **cfg["data"]["params"])
    state = {
        "x": x, "device": run.device, "seed": run.seed,
        "lasso": est["prune_kwargs"],
        "drawn": run.cell.traffic["drawn_steps"],
        # the generator's genes are in topological order
        "true_order": np.arange(cfg["d"]),
    }
    if run.program:
        from repro_torch.core import DirectLiNGAM

        state["model"] = lambda: DirectLiNGAM(
            prune_method=est["prune_method"],
            prune_kwargs=dict(est["prune_kwargs"]),
            prune_threshold=est["prune_threshold"],
            compaction=est["compaction"], device=run.device.type)
    return state


def _fit(state):
    return state["model"]().fit(state["x"])


def warmup(state):
    _fit(state)


def run_op(state, k):
    model = _fit(state)
    return model.causal_order_.copy(), model.adjacency_.copy()


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
    """``order_gap_drawn`` and ``lasso_adjacency_err`` of one fit of the
    window, drawn from the seed."""
    pick = int(runner.rng_for(state["seed"], 1).integers(len(records)))
    order, adjacency = records[pick]
    return reference_gene.judge(state["x"], order, adjacency, steps(state),
                                state["lasso"], state["device"])
