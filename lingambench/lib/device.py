"""The card: the check that one is there, its name, and its peaks."""

from __future__ import annotations

import subprocess
from typing import Optional

import torch

from . import roofline


class NoCard(RuntimeError):
    pass


def require_cards(n: int) -> torch.device:
    """The first card; raises :class:`NoCard` without ``n`` cards (the
    benchmark never falls back to the CPU)."""
    if not torch.cuda.is_available():
        raise NoCard("torch.cuda.is_available() is false: no card")
    if torch.cuda.device_count() < n:
        raise NoCard(f"the cell asks for {n} cards, "
                     f"torch sees {torch.cuda.device_count()}")
    return torch.device("cuda", 0)


def smi(fields: str) -> Optional[list]:
    """``nvidia-smi --query-gpu=<fields>`` of the first card, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={fields}",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    if out.returncode != 0 or not out.stdout.strip():
        return None
    return [v.strip() for v in out.stdout.strip().splitlines()[0].split(",")]


class Peaks:
    """The card's special-function and memory rates, or None each where
    they cannot be read (a card missing from the table, no nvidia-smi)."""

    def __init__(self, device: torch.device):
        self.name = torch.cuda.get_device_name(device)
        self.sms = torch.cuda.get_device_properties(device).multi_processor_count
        vals = smi("clocks.max.sm,power.limit")
        self.max_sm_mhz = _num(vals[0]) if vals else None
        self.power_limit_w = _num(vals[1]) if vals else None
        self.sfu_per_s = (roofline.sfu_rate(self.sms, self.max_sm_mhz * 1e6)
                          if self.max_sm_mhz else None)
        self.bytes_per_s = roofline.HBM_BYTES_PER_S.get(self.name)

    def describe(self) -> str:
        return (f"card {self.name!r}, {self.sms} SMs, max SM clock "
                f"{self.max_sm_mhz} MHz, power limit {self.power_limit_w} W, "
                f"SFU rate {self.sfu_per_s} op/s, memory {self.bytes_per_s} B/s")


def _num(s: str) -> Optional[float]:
    try:
        return float(s)
    except ValueError:
        return None
