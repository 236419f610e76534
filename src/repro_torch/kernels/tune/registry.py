"""Kernel variant registry and the single launch-plan decision point.

Every moment-kernel entry point of the port (the CUDA pair-tile kernel
B1, its row-tile and slab-structured launches B2, the fused
standardize+moments kernel B3, and the plain ``blocked`` and ``ref``
backends) is registered here as a :class:`KernelVariant` with declared
constraints. :func:`dispatch` is the **only** place a launch plan is
decided: the CUDA wrappers in ``repro_torch.kernels.pairwise_stats`` and
the dispatching wrappers in ``repro_torch.kernels.ops`` (and through them
the single, batched and streaming fit paths) ask it for a :class:`Plan`.

Resolution order inside ``dispatch``:

  1. an explicit ``plan`` given to a wrapper wins (the autotuner
     measuring a candidate, the tile sweep, a test pinning a plan);
  2. with ``mode="cache"`` (default) or ``"auto"``, the persistent
     tuning table (:mod:`repro_torch.kernels.tune.cache`) is consulted
     under the versioned ``(device_kind, op, backend, dtype, bucket)``
     key; a hit is validated against the variant's constraints before
     use, and a miss or an invalid entry falls back to the heuristic;
  3. ``mode="auto"`` runs the timed search on a miss (once per bucket,
     persisted to the overlay), except while a CUDA graph is being
     captured or ``torch.compile`` traces, where it degrades to the
     heuristic (a search there would time the capture, not the kernel);
  4. otherwise, and always for ``mode="off"``, the deterministic
     heuristic: ``pairwise_stats.tile_for``.

**Bit-parity contract.** Tuned and heuristic plans give bit-identical
moments. The only tunable field is B1/B2's pair-block edge ``tile`` (one
of ``pairwise_stats.TILES``): it re-tiles the (i, j) pair space, while
every pair's terms are summed in the same fixed 128-sample sub-sums over
the same splits and slabs in the same order, so T never changes a pair's
sums. The split plan (``pairwise_stats.split_plan``, a function of the
sample count alone, which keeps moments equal at every buffer width and
ties resolved alike) and the slab (the caller's memory bound) are not
part of a plan and cannot be tuned: a plan that changed either would
undo that width invariance. B3 has nothing tunable and always takes the
heuristic. ``validate`` rejects a table entry whose ``tile`` is not in
``TILES``; the autotuner checks every candidate's sums bit for bit
against the heuristic plan's before it records one.

A plain version runs only for tensors on the CPU: ``backend=None``
resolves to the CUDA variant, whose wrappers launch the kernel for a
CUDA tensor and run its plain version for a CPU one. ``dispatch`` for a
CUDA device raises when there is no card; it never picks a backend by
what the process happens to have.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace

from .. import pairwise_stats
from . import cache as tune_cache

#: Samples per sub-sum of the kernels' fixed reduction order.
ACCUM_CHUNK = pairwise_stats.ACCUM_CHUNK
#: The pair-block edges B1/B2 are built for: the tunable values.
TILES = pairwise_stats.TILES

_MODES = ("off", "cache", "auto")


def searching_allowed() -> bool:
    """False while a CUDA graph is being captured on the current stream
    or ``torch.compile`` traces (:func:`repro_torch.obs.trace.capturing`):
    the timed search would measure the capture or the trace, and launch
    kernels inside it."""
    return not obs_trace.capturing()


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to plan for the "
            "CPU"
        )
    return device


@functools.lru_cache(maxsize=None)
def _device_info(device: torch.device) -> Tuple[str, int]:
    if device.type != "cuda":
        return "cpu", pairwise_stats.H100_SMS
    props = torch.cuda.get_device_properties(device)
    return torch.cuda.get_device_name(device), props.multi_processor_count


def device_kind(device="cuda") -> str:
    """The table's device kind: the card's name, or ``"cpu"``."""
    return _device_info(_device(device))[0]


def dtype_token(dtype) -> str:
    """``torch.float32`` or ``"float32"`` -> ``"float32"``."""
    return str(dtype).replace("torch.", "")


def resolve_backend(backend: Optional[str]) -> str:
    """``None`` is the CUDA variant (its wrappers run the plain version
    for CPU tensors)."""
    return "cuda" if backend is None else backend


@dataclasses.dataclass(frozen=True)
class Constraints:
    """Declared constraints of one kernel variant."""

    tunable: Tuple[str, ...] = ()   # Plan fields the search may vary
    tiles: Tuple[int, ...] = TILES  # admissible pair-block edges


@dataclasses.dataclass(frozen=True)
class Plan:
    """One launch decision. Hashable, and serializable: tuning table rows
    are its dict form."""

    op: str
    variant: str
    backend: str
    tile: int = 0   # pair-block edge T of B1/B2 (0: not a B1/B2 launch)
    source: str = "heuristic"  # "heuristic" | "tuned" | "candidate"

    def to_entry(self) -> dict:
        return {"variant": self.variant, "backend": self.backend,
                "tile": self.tile}

    @classmethod
    def from_entry(cls, op: str, entry: dict) -> "Plan":
        return cls(
            op=op,
            variant=str(entry.get("variant", "")),
            backend=str(entry.get("backend", "")),
            tile=int(entry.get("tile", 0)),
            source="tuned",
        )


@dataclasses.dataclass(frozen=True)
class KernelVariant:
    """A registered entry point with its constraints and its
    deterministic plan."""

    name: str
    op: str
    backend: str
    constraints: Constraints
    heuristic: Callable[..., Plan]  # (shape, chunk, batch, sms) -> Plan
    validate: Callable[..., bool]   # (plan, shape, chunk) -> bool


REGISTRY: Dict[Tuple[str, str], KernelVariant] = {}


def register(variant: KernelVariant) -> KernelVariant:
    key = (variant.op, variant.backend)
    if key in REGISTRY:
        raise ValueError(f"duplicate kernel variant for {key}")
    REGISTRY[key] = variant
    return variant


def get_variant(op: str, backend: str) -> KernelVariant:
    try:
        return REGISTRY[(op, backend)]
    except KeyError:
        raise ValueError(
            f"no kernel variant registered for op={op!r} "
            f"backend={backend!r}; known: {sorted(REGISTRY)}"
        ) from None


# ---------------------------------------------------------------------------
# Heuristics
# ---------------------------------------------------------------------------


def _launch_extent(op: str, shape, chunk: Optional[int] = None):
    """(rows, d, n_z) of one element's B1/B2 launch for a dispatch shape:
    the pair tile and the splits over every slab of the sample axis."""
    if op == "pairwise_moment_sums_rows":
        rows, d, m = shape
        return rows, d, pairwise_stats.slab_plan(m).n_z
    m, d = shape
    slab = chunk if op == "pairwise_moment_sums_chunked" else None
    return d, d, pairwise_stats.slab_plan(m, slab).n_z


def _cuda_heuristic(op: str, name: str):
    def h(shape, chunk=None, batch=1, sms=pairwise_stats.H100_SMS) -> Plan:
        rows, d, n_z = _launch_extent(op, shape, chunk)
        return Plan(op=op, variant=name, backend="cuda",
                    tile=pairwise_stats.tile_for(rows, d, batch * n_z, sms))
    return h


def _fixed(op: str, name: str, backend: str):
    plan = Plan(op=op, variant=name, backend=backend)
    return lambda shape, chunk=None, batch=1, sms=None: plan


def _validate_cuda(variant_name: str):
    def v(plan: Plan, shape, chunk=None) -> bool:
        return (plan.backend == "cuda" and plan.variant == variant_name
                and plan.tile in TILES)
    return v


def _validate_fixed(plan: Plan, shape, chunk=None) -> bool:
    return False  # nothing tunable: heuristic only


for _op, _name in (("pairwise_moments", "cuda-pair-tile"),
                   ("pairwise_moment_sums_rows", "cuda-row-tile"),
                   ("pairwise_moment_sums_chunked", "cuda-slab-rows")):
    register(KernelVariant(
        name=_name, op=_op, backend="cuda",
        constraints=Constraints(tunable=("tile",)),
        heuristic=_cuda_heuristic(_op, _name),
        validate=_validate_cuda(_name),
    ))
for _op, _name in (("pairwise_moments", "blocked-rows"),
                   ("pairwise_moment_sums_rows", "rows-blocked"),
                   ("pairwise_moment_sums_chunked", "chunked-rows-blocked")):
    register(KernelVariant(
        name=_name, op=_op, backend="blocked", constraints=Constraints(),
        heuristic=_fixed(_op, _name, "blocked"),
        validate=_validate_fixed,
    ))
register(KernelVariant(
    name="ref-oracle", op="pairwise_moments", backend="ref",
    constraints=Constraints(),
    heuristic=_fixed("pairwise_moments", "ref-oracle", "ref"),
    validate=_validate_fixed,
))
register(KernelVariant(
    name="cuda-fused", op="fused_moment_sums", backend="cuda",
    constraints=Constraints(),
    heuristic=_fixed("fused_moment_sums", "cuda-fused", "cuda"),
    validate=_validate_fixed,
))


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------


# Dispatch runs once per kernel launch (each ordering step), so the pure
# parts of a decision are memoized.
@functools.lru_cache(maxsize=4096)
def _heuristic(variant: KernelVariant, shape, chunk, batch,
               device: torch.device) -> Plan:
    return variant.heuristic(shape, chunk, batch, _device_info(device)[1])


@functools.lru_cache(maxsize=4096)
def _table_key(op, backend, dtype, shape, batch, device: torch.device):
    return tune_cache.plan_key(_device_info(device)[0], op, backend,
                               dtype_token(dtype),
                               tune_cache.shape_bucket(op, shape, batch))


def dispatch_heuristic(
    op: str, shape, *, backend: Optional[str] = None,
    chunk: Optional[int] = None, batch: int = 1, device="cuda",
) -> Plan:
    """The deterministic plan (no table, no measurement)."""
    return _heuristic(get_variant(op, resolve_backend(backend)),
                      tuple(shape), chunk, batch, _device(device))


def dispatch(
    op: str,
    shape,
    dtype="float32",
    backend: Optional[str] = None,
    *,
    mode: str = "cache",
    chunk: Optional[int] = None,
    batch: int = 1,
    device="cuda",
    table: Optional[tune_cache.TuneTable] = None,
) -> Plan:
    """The single launch-plan decision point.

    Args:
      op:     registered op name ("pairwise_moments",
              "pairwise_moment_sums_rows", "pairwise_moment_sums_chunked",
              "fused_moment_sums").
      shape:  one element's dispatch shape: (m, d) for the pair and
              chunked ops, (tile, d, m) for the row and fused ops.
      dtype:  input dtype (part of the tuning key).
      backend: "cuda" (also for ``None``), "blocked" or "ref".
      mode:   "off" (heuristic, deterministic), "cache" (table lookup,
              heuristic fallback; never measures), "auto" (search and
              persist on a miss).
      chunk:  the caller's sample slab, for the chunked op.
      batch:  the leading batch axis of the launch (1 for a single one).
      device: where the launch runs: the card's name keys the table; a
              CUDA device without a card raises.
      table:  an explicit :class:`TuneTable` (tests, benchmarks); defaults
              to the process singleton.
    """
    if not obs_trace.enabled():
        return _dispatch_resolve(op, shape, dtype, backend, mode=mode,
                                 chunk=chunk, batch=batch, device=device,
                                 table=table)
    with obs_trace.span("kernels.dispatch", op=op, shape=tuple(shape),
                        mode=mode, batch=batch) as sp:
        plan = _dispatch_resolve(op, shape, dtype, backend, mode=mode,
                                 chunk=chunk, batch=batch, device=device,
                                 table=table)
        sp.set(variant=plan.variant, source=plan.source, tile=plan.tile)
    # Per-variant dispatch counts and tuned-vs-heuristic provenance.
    obs_metrics.inc("kernels.dispatch", op=op, backend=plan.backend,
                    variant=plan.variant, source=plan.source)
    return plan


def _dispatch_resolve(
    op: str,
    shape,
    dtype="float32",
    backend: Optional[str] = None,
    *,
    mode: str = "cache",
    chunk: Optional[int] = None,
    batch: int = 1,
    device="cuda",
    table: Optional[tune_cache.TuneTable] = None,
) -> Plan:
    if mode not in _MODES:
        raise ValueError(f"unknown tune mode {mode!r}; expected {_MODES}")
    backend = resolve_backend(backend)
    variant = get_variant(op, backend)
    device = _device(device)
    shape = tuple(shape)
    heuristic = _heuristic(variant, shape, chunk, batch, device)
    if mode == "off" or not variant.constraints.tunable:
        return heuristic
    tbl = table if table is not None else tune_cache.get_table()
    entry = tbl.lookup(_table_key(op, backend, str(dtype), shape, batch,
                                  device))
    if entry is not None:
        plan = Plan.from_entry(op, entry)
        # An entry that fails validation degrades to the heuristic,
        # deterministically, with no re-search.
        return plan if variant.validate(plan, shape, chunk) else heuristic
    if mode == "auto" and not tbl.offline and searching_allowed():
        from . import autotune  # lazy: autotune drives the wrappers

        return autotune.autotune_op(
            op, shape, dtype=dtype, backend=backend, chunk=chunk,
            batch=batch, device=device, table=tbl,
        ).best
    return heuristic
