"""Run a list of mesh-plan cells on every rank of a ``torchrun`` world and
write each rank's results: the multi-rank driver behind the mesh tests
and ``chip_smoke.py``'s four ranks on one card.

    python -m torch.distributed.run --standalone --nproc-per-node 4 \\
        -m repro_torch.launch.mesh_cells OUT_DIR CELLS.json \\
        [--device cuda|cpu] [--backend gloo|nccl]

``CELLS.json`` holds a list of cells, each a dict with a ``key`` and a
``kind``:

  * ``"fit"`` -- ``api.fit_fn`` on ``simulate_lingam(m, d, seed)`` with
    ``FitConfig(**config, partition=Partition(**partition))``; with
    ``"timed": true`` a warm-up fit first, then the fit timed to the end
    of the device's work with the kernels' launch counts;
  * ``"order"`` -- ``sharded_causal_order`` on ``simulate_lingam(m, d,
    seed)`` over the mesh ``mesh`` (``sample_axes``, ``chunk``,
    ``fused_standardize``); ``"timed": true`` as for a fit;
  * ``"engine"`` -- the serving engine's mesh regime on ``n`` datasets
    ``simulate_lingam(m, d, seed=s)``, each beside ``fit_fn`` on that
    dataset alone (keys ``KEY/s`` and ``KEY/s/direct``);
  * ``"varlingam"`` -- the VarLiNGAM facade through ``partition`` on
    ``simulate_var_stocks(m, d, edge_prob, seed)``, beside ``fit_fn`` on
    its residuals and the true ``b0``.

Each rank first checks that the backend carries ``all_reduce`` and
``all_gather_into_tensor`` on the device's tensors; if it does not, the
error is recorded and no cell runs. Rank r writes ``rank{r}.npz`` (every
result array under ``KEY/NAME``) and ``rank{r}.json`` (the collective
check, and each timed cell's seconds and B1/B2 launches), then prints
``RANK_DONE r``. On a card every rank takes card ``LOCAL_RANK`` modulo
the number of cards: on one card the ranks share it (over gloo; NCCL
will not put two ranks on one card).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import VarLiNGAM, api
from repro_torch.core.sharded import sharded_causal_order
from repro_torch.data.simulate import simulate_lingam, simulate_var_stocks
from repro_torch.kernels import pairwise_stats
from repro_torch.launch import mesh as launch_mesh
from repro_torch.serve.engine import CausalDiscoveryEngine, FitRequest

LEAVES = ("order", "adjacency", "resid_var")


def _x(data, dev):
    return torch.as_tensor(np.ascontiguousarray(data, np.float32),
                           device=dev)


def _leaves(fit):
    """(order, adjacency, resid_var) of a fit as numpy arrays (tensors
    from ``fit_fn``, arrays from the engine)."""
    return [(v.cpu().numpy() if torch.is_tensor(v) else np.asarray(v))
            for v in (getattr(fit, n) for n in LEAVES)]


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def collectives_ok(dev) -> str:
    """"ok" when the process group's backend carries ``all_reduce`` and
    ``all_gather_into_tensor`` on ``dev``'s tensors, else the error."""
    try:
        t = torch.ones(4, device=dev)
        dist.all_reduce(t)
        g = torch.empty(4 * dist.get_world_size(), device=dev)
        dist.all_gather_into_tensor(g, t)
        _sync(dev)
    except RuntimeError as e:
        return f"{type(e).__name__}: {e}"
    if not (bool((t == dist.get_world_size()).all())
            and bool((g == dist.get_world_size()).all())):
        return "the collectives returned wrong sums"
    return "ok"


def _run(cell, dev, report, fn):
    """``fn()`` once; with ``"timed"`` a warm-up run first, then the run
    timed to the end of the device's work (all ranks starting together)
    with the kernels' launch counts, into ``report[cell["key"]]``."""
    timed = cell.get("timed")
    if timed:
        fn()  # warm
        pairwise_stats.launches = pairwise_stats.rows_launches = 0
        _sync(dev)
        dist.barrier()
    t0 = time.perf_counter()
    out = fn()
    _sync(dev)
    if timed:
        report[cell["key"]] = {"s": time.perf_counter() - t0,
                               "b1": pairwise_stats.launches,
                               "b2": pairwise_stats.rows_launches}
    return out


def run_cell(cell, dev, res, report):
    """Run one cell on this rank: arrays into ``res``, timings into
    ``report``."""
    key, kind = cell["key"], cell["kind"]
    if kind == "fit":
        x = _x(simulate_lingam(m=cell["m"], d=cell["d"],
                               seed=cell["seed"]).data, dev)
        cfg = api.FitConfig(**cell.get("config", {}),
                            partition=api.Partition(**cell["partition"]))
        fit = _run(cell, dev, report, lambda: api.fit_fn(x, cfg))
        for name, leaf in zip(LEAVES, _leaves(fit)):
            res[f"{key}/{name}"] = leaf
    elif kind == "order":
        x = _x(simulate_lingam(m=cell["m"], d=cell["d"],
                               seed=cell["seed"]).data, dev)
        mesh = launch_mesh.mesh_from_spec(cell["mesh"], dev.type)
        res[key] = _run(cell, dev, report, lambda: sharded_causal_order(
            x, mesh, sample_axes=tuple(cell.get("sample_axes", ("data",))),
            chunk=cell["chunk"],
            fused_standardize=cell.get("fused_standardize", False),
        )).cpu().numpy()
    elif kind == "engine":
        cfg = api.FitConfig(**cell.get("config", {}),
                            partition=api.Partition(**cell["partition"]))
        datasets = [simulate_lingam(m=cell["m"], d=cell["d"], seed=s).data
                    for s in range(cell["n"])]
        eng = CausalDiscoveryEngine(cfg, device=dev.type)
        done = eng.run([FitRequest(data=data) for data in datasets])
        for s, (req, data) in enumerate(zip(done, datasets)):
            direct = api.fit_fn(_x(data, dev), cfg)
            for name, a, b in zip(LEAVES, _leaves(req.result),
                                  _leaves(direct)):
                res[f"{key}/{s}/{name}"] = a
                res[f"{key}/{s}/direct/{name}"] = b
    elif kind == "varlingam":
        xv, b0, _ = simulate_var_stocks(
            m=cell["m"], d=cell["d"], edge_prob=cell["edge_prob"],
            seed=cell["seed"])
        v = VarLiNGAM(**cell.get("facade", {}),
                      partition=api.Partition(**cell["partition"]),
                      device=dev.type).fit(xv)
        direct = api.fit_fn(_x(v.residuals_, dev), v.to_config())
        res[f"{key}/order"] = v.causal_order_
        res[f"{key}/b0"] = v.adjacency_matrices_[0]
        res[f"{key}/direct_order"] = direct.order.cpu().numpy()
        res[f"{key}/direct_b0"] = direct.adjacency.cpu().numpy()
        res[f"{key}/true_b0"] = b0
    else:
        raise ValueError(f"unknown cell kind {kind!r}")


def launch(cells, out_dir, *, nproc: int = 4, device: str = "cuda",
           backend: str = None, timeout: float = 600):
    """Run ``cells`` on ``nproc`` ranks under ``torchrun`` (one
    ``subprocess`` with its own ``timeout``), this package on the ranks'
    path. Returns (the finished process, each rank's report, each rank's
    arrays); raises when a rank failed."""
    os.makedirs(out_dir, exist_ok=True)
    spec = os.path.join(out_dir, "cells.json")
    with open(spec, "w") as f:
        json.dump(cells, f)
    src = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        p for p in (src, os.environ.get("PYTHONPATH")) if p))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(nproc), "-m", __name__, out_dir, spec,
           "--device", device]
    if backend:
        cmd += ["--backend", backend]
    proc = subprocess.run(cmd, capture_output=True, text=True, env=env,
                          timeout=timeout)
    if proc.returncode != 0 or proc.stdout.count("RANK_DONE") != nproc:
        raise RuntimeError(
            f"the {nproc} mesh ranks failed (exit {proc.returncode}):\n"
            f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    reports, arrays = [], []
    for r in range(nproc):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            reports.append(json.load(f))
        arrays.append(dict(np.load(os.path.join(out_dir, f"rank{r}.npz"))))
    return proc, reports, arrays


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out_dir")
    ap.add_argument("cells", help="a JSON file holding the list of cells")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--backend", default=None,
                    help="the collective backend (default: NCCL on the "
                         "card, gloo on the CPU)")
    args = ap.parse_args(argv)
    if args.device == "cpu":
        torch.set_num_threads(1)
        dev = torch.device("cpu")
    else:
        index = int(os.environ.get("LOCAL_RANK", 0)) % max(
            torch.cuda.device_count(), 1)
        torch.cuda.set_device(index)
        dev = torch.device("cuda", index)
    rank = launch_mesh.init_from_env(args.backend, args.device)
    with open(args.cells) as f:
        cells = json.load(f)
    res, report = {}, {"rank": rank, "collectives": collectives_ok(dev)}
    if report["collectives"] == "ok":
        for cell in cells:
            run_cell(cell, dev, res, report)
    np.savez(os.path.join(args.out_dir, f"rank{rank}.npz"), **res)
    with open(os.path.join(args.out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(report, f)
    dist.destroy_process_group()
    print("RANK_DONE", rank, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
