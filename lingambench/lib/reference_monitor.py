"""The monitored stream's check: the drift statistics and alerts of one
posted chunk, recomputed in float64 from the chunk's raw rows and the
graph the session served when it was scored, in plain PyTorch and NumPy.

The functions here import neither the port nor the JAX package, and
take nothing the port made but the served graph (the input the monitor
scores against) and the alerts they judge.

Under a served VarLiNGAM graph (B0, A, c, noise variances v) a chunk's
structural noise is ``e = (I - B0) (y - c - A z)``, ``[y, z]`` its
lag-augmented rows, computed here row by row. Per variable j, over the
chunk's n rows:

* ``z_mean`` = mean(e_j) sqrt(n / v_j), alert kind ``weight-shift``;
* ``z_var`` = (mean(e_j^2) / v_j - 1) sqrt(n / 2), kind ``noise-scale``;
* ``z_dep`` = (n sum_{i != j} corr(e_i, e_j)^2 / (d - 1) - 1)
  sqrt((d - 1) / 2), kind ``edge-flip``.

A monitor armed on the graph before the chunk holds CUSUM levels
max(0, z - s) (and max(0, -z - s) for the first two), with slacks s =
slack, slack + var_slack, slack + dep_slack, and alerts where a level
exceeds the threshold, kind by kind and variable by variable; a
session keeps the newest ``max_pending`` alerts unread. Numbers:

* ``monitor_z_err`` -- over the delivered alerts, the largest
  |stat - stat_ref| / max(1, |stat_ref|);
* ``monitor_alert_diff`` -- (variable, kind) pairs alerted by one side
  and not the other, leaving out pairs whose float64 level lies within
  :data:`LEVEL_TOL` of the threshold. Where the delivered alerts fill
  the session's ring, only the reference's alerts from the first
  delivered one on are owed.

The control (:func:`control_numbers`) computes the statistics in float32
with TF32 products (``"lower"``; ``"bfloat16"`` products on a CPU) and
delivers its own alerts in the program's place. It needs the graphs the
program served, so :func:`main` runs the cell's driver with the program
and judges the control on the post the run's check draws:

    python3 -m lingambench.lib.reference_monitor --seeds 11,12,13
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from . import reference

KINDS = ("weight-shift", "noise-scale", "edge-flip")
LEVEL_TOL = 1e-3   # levels this near the threshold may fire either way


def _mm(a, b, mode):
    """a @ b: float64 for ``"reference"``, else float32 from the mode's
    products."""
    if mode == "reference":
        return a.double() @ b.double()
    if mode == "bfloat16":
        return (a.bfloat16() @ b.bfloat16()).float()
    return a.float() @ b.float()


def chunk_stats(rows, lags, graph, mode="reference") -> np.ndarray:
    """(3, d) float64: z_mean, z_var, z_dep of the chunk whose raw rows
    (its ``lags`` predecessors, then the chunk) are ``rows``, under
    ``graph`` (``a`` (d, lags d), ``intercept``, ``b0``, ``resid_var``)."""
    dev = graph["b0"].device
    dt = torch.float64 if mode == "reference" else torch.float32
    x = torch.as_tensor(np.asarray(rows), device=dev).to(dt)
    n_all, d = x.shape
    y = x[lags:]
    z = torch.cat([x[lags - tau:n_all - tau] for tau in range(1, lags + 1)],
                  dim=1)
    a, c, b0 = (graph[k].to(dt) for k in ("a", "intercept", "b0"))
    v0 = torch.clamp(graph["resid_var"].double(), min=1e-12)
    eye = torch.eye(d, dtype=dt, device=dev)
    with torch.no_grad(), reference.precision(mode):
        r = y - c - _mm(z, a.T, mode)
        e = _mm(r, (eye - b0).T, mode)
        n = e.shape[0]
        mean = e.mean(0)
        ec = e - mean
        var = (ec * ec).mean(0)
        cov = _mm(ec.T, ec, mode) / n
    mean, var, cov = mean.double(), var.double(), cov.double()
    z_mean = mean * torch.sqrt(n / v0)
    z_var = ((var + mean * mean) / v0 - 1.0) * (n / 2.0) ** 0.5
    sd = torch.sqrt(torch.clamp(var, min=1e-12))
    corr = cov / (sd[:, None] * sd[None, :])
    corr.fill_diagonal_(0.0)
    dep = n * (corr * corr).sum(1) / max(d - 1, 1)
    z_dep = (dep - 1.0) * (max(d - 1, 1) / 2.0) ** 0.5
    return torch.stack([z_mean, z_var, z_dep]).cpu().numpy()


def levels(z, cfg) -> np.ndarray:
    """(3, d) CUSUM levels of a monitor armed just before the chunk."""
    s = np.array([cfg["slack"], cfg["slack"] + cfg["var_slack"],
                  cfg["slack"] + cfg["dep_slack"]])[:, None]
    level = np.maximum(0.0, z - s)
    level[:2] = np.maximum(level[:2], -z[:2] - s[:2])
    return level


def fired(level, cfg):
    """The alerts a monitor fires, in its order: [(kind index, variable)],
    kind by kind, variables ascending."""
    return [(k, int(j)) for k in range(3)
            for j in np.nonzero(level[k] > cfg["threshold"])[0]]


def alert_diff(delivered, level, cfg) -> int:
    """``monitor_alert_diff`` of the delivered (kind index, variable)
    pairs against the float64 levels (the module's docstring)."""
    h = cfg["threshold"]
    sure = {p for p in fired(level, cfg) if level[p] > h + LEVEL_TOL}
    near = {(k, int(j)) for k, j in zip(*np.nonzero(
        np.abs(level - h) <= LEVEL_TOL))}
    got = set(delivered)
    extra = got - sure - near
    owed = sure
    if len(delivered) >= cfg["max_pending"]:
        first = min(delivered)
        owed = {p for p in sure if p >= first}
    return len(extra) + len(owed - got)


def judge(rows, lags, graph, delivered, cfg) -> dict:
    """``monitor_z_err`` and ``monitor_alert_diff`` of the alerts
    ``delivered`` for one post, [(kind, variable, stat)] as received."""
    z = chunk_stats(rows, lags, graph)
    level = levels(z, cfg)
    if len(rows) - lags < cfg["min_count"]:
        level[:] = 0.0
    pairs = [(KINDS.index(kind), int(j)) for kind, j, _ in delivered]
    errs = [abs(stat - z[p]) / max(1.0, abs(z[p]))
            for p, (_, _, stat) in zip(pairs, delivered)]
    return {"monitor_z_err": float(max(errs, default=0.0)),
            "monitor_alert_diff": float(alert_diff(pairs, level, cfg))}


def control_numbers(rows, lags, graph, cfg, mode) -> dict:
    """The control's numbers: its own statistics in ``mode`` and the
    alerts they fire (the newest ``max_pending``), judged as the
    program's."""
    z = chunk_stats(rows, lags, graph, mode)
    pairs = fired(levels(z, cfg), cfg)[-cfg["max_pending"]:]
    return judge(rows, lags, graph,
                 [(KINDS[k], j, float(z[k, j])) for k, j in pairs], cfg)


def main(argv=None, device=None):
    """The control on ``--seeds``: the cell's warm-up and ``--slides``
    slides with the program, then one JSON line a seed and mode of the
    control's and the program's numbers on the drawn post."""
    p = argparse.ArgumentParser(prog="lingambench.lib.reference_monitor")
    p.add_argument("--workload", default="varlingam-stocks-487.monitored-stream")
    p.add_argument("--seeds", required=True)
    p.add_argument("--modes", default="lower",
                   help="comma-separated: lower, bfloat16")
    p.add_argument("--slides", type=int, default=3)
    args = p.parse_args(argv)
    from . import device as dev
    from . import runner, spec

    cell = spec.load_cell(args.workload)
    if device is None:
        device = dev.require_cards(cell.chips)
    torch.set_float32_matmul_precision("highest")
    driver = cell.driver()
    for seed in (int(s) for s in args.seeds.split(",")):
        state = driver.setup(runner.Run(cell, seed, device))
        driver.warmup(state)
        for k in range(args.slides):
            driver.run_op(state, k)
        rows, graph, delivered = driver.drawn_alerts(state)
        program = judge(rows, state["lags"], graph, delivered,
                        state["monitor"])
        for mode in args.modes.split(","):
            t0 = time.perf_counter()
            numbers = control_numbers(rows, state["lags"], graph,
                                      state["monitor"], mode)
            print(json.dumps({"workload": cell.name, "seed": seed,
                              "mode": mode, "numbers": numbers,
                              "program": program,
                              "alerts": len(delivered),
                              "seconds": time.perf_counter() - t0}),
                  flush=True)
        driver.release(state)
    return 0


if __name__ == "__main__":
    sys.exit(main())
