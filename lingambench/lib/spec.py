"""What one run needs from ``BENCHMARK.json`` and the files it names.

Everything that belongs to one configuration, one traffic mix, one cell
or one metric lives in a file of its own, found by name:

* ``configs/<config>.json`` -- the configuration (the file that the
  ``configs`` entry of ``BENCHMARK.json`` names);
* ``traffic/<traffic>.json`` -- the traffic mix: the driver that runs it
  (``drivers/<driver>.py``) and its parameters;
* ``limits/<cell>.json`` -- the limits that decide ``correct`` in the
  cell, with the readings each was set from;
* ``metrics/<family>.py`` -- the reader of every metric named
  ``<family>`` or ``<family>.<anything>``.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
from pathlib import Path
from typing import Dict, List

PACKAGE = "lingambench"
ROOT = Path(__file__).resolve().parents[1]       # the benchmark's folder
CHECKOUT = ROOT.parent                           # the repository's root


class SpecError(RuntimeError):
    pass


@dataclasses.dataclass
class Metric:
    name: str
    unit: str

    @property
    def family(self) -> str:
        return self.name.split(".", 1)[0]

    def reader(self):
        """The module ``metrics/<family>.py``; its ``read(ctx)`` returns the
        value or None where it finds nothing to read."""
        return importlib.import_module(f"{PACKAGE}.metrics.{self.family}")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[Metric]
    per_layer: List[Metric]

    def driver(self):
        return importlib.import_module(
            f"{PACKAGE}.drivers.{self.traffic['driver']}")


def _read_json(path: Path) -> dict:
    if not path.is_file():
        raise SpecError(f"missing file {path}")
    with open(path) as f:
        return json.load(f)


def _metrics(entries, cell) -> List[Metric]:
    return [Metric(e["name"], e["unit"]) for e in entries
            if "workloads" not in e or cell in e["workloads"]]


def load_cell(name: str, checkout: Path = CHECKOUT) -> Cell:
    """The cell ``name`` of ``<checkout>/BENCHMARK.json``."""
    spec = _read_json(checkout / "BENCHMARK.json")
    cells: Dict[str, dict] = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SpecError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    if w["config"] not in configs:
        raise SpecError(f"workload {name!r} names no known config")
    root = checkout / PACKAGE
    return Cell(
        name=name,
        chips=int(w["chips"]),
        config=_read_json(checkout / configs[w["config"]]["file"]),
        traffic=_read_json(root / "traffic" / f"{w['traffic']}.json"),
        limits=_read_json(root / "limits" / f"{name}.json"),
        end_to_end=_metrics(spec["end_to_end"], name),
        per_layer=_metrics(spec["per_layer"], name),
    )
