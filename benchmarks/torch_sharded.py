"""Mesh-plan sweep on the port: ordering and fit time per mesh shape
against the local ``causal_order`` oracle -> BENCH_torch_sharded.json.

    PYTHONPATH=src python3 -m benchmarks.torch_run --only sharded [--full]

The reference bench (``benchmarks/bench_sharded.py``) forces 8 host
devices into one JAX program. The port's mesh plan runs one process a
rank over ``torch.distributed``, so each mesh shape here is one
``torchrun`` world launched through the port's rank driver
(:func:`repro_torch.launch.mesh_cells.launch`): 1 x 1 is a world of one
(NCCL on the card, gloo on the CPU); 2 x 2 and 4 x 1 are four gloo ranks
and 8 x 1 eight, all sharing the one card. Each world times, after a
warm-up, the sharded ordering (``sharded_causal_order``: one B2 launch a
step on each rank at its ``row_start``) and the whole sharded fit
(``fit_fn`` with a ``Partition``, staged compaction), on every rank to
the end of its device's work; a row reports the slowest rank. The
oracle is the local ``causal_order`` in this process (one B1 launch a
step on the card).

Every collective of a rank sharing the card goes through the host, so
this measures the plan's overhead, not scaling. Orders are compared with
the oracle's: ``order_n_disagree`` counts the positions that differ, and
where they part, the two roots must tie at the first parting
(:func:`benchmarks.torch_equivalence.parting_tie`): shards group the
kernel's 128-sample sub-sums otherwise than the local plan does, so a
near-tied argmax may resolve either way.
"""

from __future__ import annotations

import tempfile

import numpy as np
import torch

from repro_torch.core import api, ordering
from repro_torch.data.simulate import simulate_lingam
from repro_torch.launch import mesh_cells

from benchmarks.torch_common import clock, launch_counts, launches_since
from benchmarks.torch_equivalence import parting_tie

MESHES = {
    "1x1": (("data", 1), ("model", 1)),
    "2x2": (("data", 2), ("model", 2)),
    "4x1": (("data", 4), ("model", 1)),
    "8x1": (("data", 8), ("model", 1)),
}
NOTE = ("one card: the ranks of a mesh share it and every collective of "
        "more than one rank goes through the host (gloo), so these rows "
        "measure the mesh plan's overhead, not scaling")


def sizes(quick: bool):
    """(m, d, chunk): the reference bench's sizes."""
    return (2048, 32, 256) if quick else (16_384, 96, 512)


def _cells(label, m, d, chunk):
    mesh = MESHES[label]
    return [
        dict(key=f"{label}/order", kind="order", m=m, d=d, seed=0,
             mesh=mesh, chunk=chunk, timed=True),
        dict(key=f"{label}/fit", kind="fit", m=m, d=d, seed=0, timed=True,
             config=dict(compaction="staged"),
             partition=dict(mesh=mesh, chunk=chunk)),
    ]


def _world(labels, m, d, chunk, device):
    """Run the meshes ``labels`` (one world size) in one ``torchrun``
    world; returns each rank's report and rank 0's arrays."""
    world = int(np.prod([s for _, s in MESHES[labels[0]]]))
    cells = [c for label in labels for c in _cells(label, m, d, chunk)]
    backend = "gloo" if world > 1 else None
    with tempfile.TemporaryDirectory(prefix="repro-torch-sharded-") as tmp:
        _, reports, arrays = mesh_cells.launch(
            cells, tmp, nproc=world, device=device.type, backend=backend,
            timeout=1800)
    return world, backend, reports, arrays[0]


def run(quick: bool = True, device="cuda", meshes=None):
    """``meshes``: the labels of ``MESHES`` to run (default: all)."""
    device = api.resolve_device(device)
    m, d, chunk = sizes(quick)
    labels = list(meshes or MESHES)
    before = launch_counts()
    x = torch.as_tensor(np.ascontiguousarray(
        simulate_lingam(m=m, d=d, seed=0).data, np.float32), device=device)
    ordering.causal_order(x).cpu()  # warm
    t0 = clock(device)
    oracle = ordering.causal_order(x).cpu().numpy()
    t_oracle = clock(device) - t0

    by_world = {}
    for label in labels:
        world = int(np.prod([s for _, s in MESHES[label]]))
        by_world.setdefault(world, []).append(label)
    rows, refused = [], []
    for group in by_world.values():
        world, backend, reports, got = _world(group, m, d, chunk, device)
        collectives = reports[0]["collectives"]
        for label in group:
            row = {"mesh": label, "m": m, "d": d, "chunk": chunk,
                   "ranks": world, "collective_backend": backend or "default",
                   "collectives": collectives}
            rows.append(row)
            if collectives != "ok":
                refused.append(label)
                continue
            order = got[f"{label}/order"][:d]
            timed = {k: [rep[f"{label}/{k}"] for rep in reports]
                     for k in ("order", "fit")}
            part, ratio = parting_tie(x, oracle, order,
                                      ordering.LocalReducer())
            t_order = max(t["s"] for t in timed["order"])
            row.update({
                "order_s": t_order, "order_step_ms": 1e3 * t_order / d,
                "fit_s": max(t["s"] for t in timed["fit"]),
                "oracle_order_s": t_oracle,
                "order_matches_oracle": bool(np.array_equal(order, oracle)),
                "order_n_disagree": int((order != oracle).sum()),
                "parting_step": part,
                "parting_gap_ratio": ratio,
                "order_tie_or_match": ratio <= 1.0,
                "fit_order_matches_oracle": bool(np.array_equal(
                    got[f"{label}/fit/order"][:d], oracle)),
                "b2_launches_per_rank": [t["b2"] for t in timed["order"]],
                "b1_launches_per_rank": [t["b1"] for t in timed["order"]],
            })
            print(f"torch_sharded,mesh={label},m={m},d={d},"
                  f"order={t_order:.3f}s,step={row['order_step_ms']:.1f}ms,"
                  f"fit={row['fit_s']:.3f}s,oracle={t_oracle:.3f}s,"
                  f"match={row['order_matches_oracle']},"
                  f"n_disagree={row['order_n_disagree']},"
                  f"parting_ratio={ratio:.3f},"
                  f"b2_per_rank={row['b2_launches_per_rank']}")
    if refused:
        raise RuntimeError(
            f"the collectives of meshes {refused} refused this device's "
            f"tensors: {rows}")
    return {"note": NOTE, "rows": rows, "launches": launches_since(before)}
