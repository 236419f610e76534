"""The run's last lines: each compared number beside its limit on
standard error, then one JSON object on standard output."""

from __future__ import annotations

import json
import sys
from typing import Dict, Optional


def compare(numbers: Dict[str, float], limits: Dict[str, dict]) -> dict:
    """{name: {"value", "limit"}} for every limit of the cell, in the
    limits' order; a number that is missing or not finite reads None and
    fails."""
    out = {}
    for name, lim in limits.items():
        v = numbers.get(name)
        out[name] = {"value": v, "limit": lim["limit"]}
    return out


def passed(checks: dict) -> bool:
    return bool(checks) and all(
        c["value"] is not None and c["value"] == c["value"]
        and c["value"] <= c["limit"] for c in checks.values())


def result_line(*, correct: bool, attempted: int, failed: int,
                metrics: Dict[str, dict], device: dict,
                breakdown: Optional[dict], checks: dict) -> str:
    """The last line of standard output; ``checks`` comes last."""
    obj = {"correct": correct, "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": device}
    if breakdown is not None:
        obj["breakdown"] = breakdown
    obj["checks"] = checks
    return json.dumps(obj)


def print_checks(checks: dict, stream=sys.stderr) -> None:
    for name, c in checks.items():
        print(f"check {name} = {c['value']!r} limit {c['limit']!r}",
              file=stream)
    stream.flush()
