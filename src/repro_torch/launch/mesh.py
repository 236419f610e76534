"""Device meshes for the mesh plan, over ``torch.distributed`` (the port
of the reference's ``launch/mesh.py``).

A mesh spec is a tuple of (axis_name, size) pairs, e.g.
``(("data", 2), ("model", 2))``; :func:`mesh_from_spec` builds the
``torch.distributed.device_mesh.DeviceMesh`` with those named axes over
the process group, one process a rank. Ranks of a mesh larger than one
are started by a launcher (``torchrun``) and join with
:func:`init_from_env`. A 1 x 1 mesh needs no launcher:
:func:`mesh_scope` sets up a world of one in this process (an in-process
store; NCCL on a card, gloo on the CPU) and tears it down when the scope
exits, so nothing outlives the call. Nothing here touches
``torch.distributed`` at import time.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.distributed as dist

# Meshes built over the live process group, by (axis names, sizes,
# device type, group): building one creates a process group per axis,
# so a mesh is built once per world and reused by later fits.
_MESHES: dict = {}


def backend_for(device_type: str) -> str:
    """The collective backend of a device type: NCCL on the card, gloo on
    the CPU."""
    return "nccl" if device_type == "cuda" else "gloo"


def init_from_env(backend: str = None, device_type: str = "cuda") -> int:
    """Join the process group a launcher (``torchrun``) describes in the
    environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT``); returns this process's rank. ``backend`` defaults to
    :func:`backend_for` of ``device_type``."""
    if not dist.is_initialized():
        dist.init_process_group(backend or backend_for(device_type),
                                init_method="env://")
    return dist.get_rank()


def _spec(spec):
    names = tuple(str(a) for a, _ in spec)
    sizes = tuple(int(s) for _, s in spec)
    return names, sizes


def mesh_from_spec(spec, device_type: str = "cuda"):
    """The ``DeviceMesh`` of a ((axis_name, size), ...) spec over the live
    process group, whose world size must be the product of the sizes.

    The canonical constructor for :class:`repro_torch.core.api.Partition`
    mesh specs. Raises when no process group exists: launch the ranks
    with ``torchrun`` (and :func:`init_from_env`), or use
    :func:`mesh_scope`, which sets up a world of one for a 1 x 1 spec.
    """
    from torch.distributed.device_mesh import DeviceMesh

    names, sizes = _spec(spec)
    n = math.prod(sizes)
    if not dist.is_initialized():
        raise RuntimeError(
            f"mesh {dict(zip(names, sizes))} needs a process group of {n} "
            "ranks: start them with torchrun (init_from_env), or use "
            "mesh_scope for a 1 x 1 mesh")
    if dist.get_world_size() != n:
        raise ValueError(
            f"mesh {dict(zip(names, sizes))} spans {n} ranks, but the "
            f"process group has {dist.get_world_size()}")
    key = (names, sizes, device_type, id(dist.group.WORLD))
    mesh = _MESHES.get(key)
    if mesh is None:
        mesh = DeviceMesh(device_type, torch.arange(n).reshape(sizes),
                          mesh_dim_names=names)
        _MESHES[key] = mesh
    return mesh


@contextlib.contextmanager
def mesh_scope(spec, device_type: str = "cuda"):
    """Yields :func:`mesh_from_spec` of ``spec``. When no process group
    exists and the spec spans one rank, a world of one is set up for the
    scope and destroyed on exit (scopes nest: an inner one reuses it)."""
    own = not dist.is_initialized() and math.prod(_spec(spec)[1]) == 1
    if own:
        if device_type == "cuda":
            torch.cuda.set_device(torch.cuda.current_device())
        dist.init_process_group(backend_for(device_type),
                                store=dist.HashStore(), world_size=1,
                                rank=0)
    try:
        yield mesh_from_spec(spec, device_type)
    finally:
        if own:
            _MESHES.clear()
            dist.destroy_process_group()


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """The reference's production layout: a 16 x 16 ("data", "model")
    mesh, or 2 x 16 x 16 with a "pod" axis: 256 or 512 ranks."""
    if multi_pod:
        return mesh_from_spec((("pod", 2), ("data", 16), ("model", 16)),
                              device_type)
    return mesh_from_spec((("data", 16), ("model", 16)), device_type)


def make_debug_mesh(n_data: int = 4, n_model: int = 2, *, pod: int = 0,
                    device_type: str = "cuda"):
    """A small mesh for multi-process integration tests (a card mesh
    unless ``device_type="cpu"``)."""
    if pod:
        return mesh_from_spec(
            (("pod", pod), ("data", n_data), ("model", n_model)),
            device_type)
    return mesh_from_spec((("data", n_data), ("model", n_model)),
                          device_type)
