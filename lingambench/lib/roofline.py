"""The benchmark's own count of the work an ordering needs, and its least
time on the card.

Step k of a d-variable causal ordering has w = d - k active variables and
needs the two nonlinear moments of every ordered pair's regression
residual over the m samples: w (w - 1) pair terms, each three
special-function operations (two exp, one log). Over the whole ordering
that is sum_{w=1..d} w (w - 1) = (d + 1) d (d - 1) / 3 terms a sample,
whatever schedule (masked scan, staged compaction) computes them: the
count is of what the inputs need, not of what one implementation runs.
Each input byte (the (m, d) float32 data) is read once and each output
byte (the (d,) int64 order) written once.

The least time is the larger of the operations over the card's
special-function rate (SMs x 16 a clock x the maximum SM clock) and the
bytes over its memory rate.
"""

from __future__ import annotations

SFU_OPS_PER_TERM = 3
SFU_PER_SM_PER_CLOCK = 16

# Memory rate by the name torch.cuda.get_device_name() gives (NVIDIA's
# data sheet). A card missing here has no roofline metrics.
HBM_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}


def pair_terms(d: int) -> int:
    """sum over the steps of an ordering of d variables of w (w - 1)."""
    return (d + 1) * d * (d - 1) // 3


def ordering_work(m: int, d: int, batch: int = 1):
    """(special-function operations, bytes) that ``batch`` orderings of
    (m, d) data need."""
    ops = SFU_OPS_PER_TERM * pair_terms(d) * m * batch
    nbytes = batch * (4 * m * d + 8 * d)
    return ops, nbytes


def sfu_rate(sms: int, max_sm_clock_hz: float) -> float:
    """Special-function operations a second: SMs x 16 x the clock."""
    return sms * SFU_PER_SM_PER_CLOCK * max_sm_clock_hz


def least_seconds(ops: float, nbytes: float, sfu_per_s: float,
                  bytes_per_s: float) -> float:
    return max(ops / sfu_per_s, nbytes / bytes_per_s)


def ordering_least_seconds(shapes, sfu_per_s: float,
                           bytes_per_s: float) -> float:
    """Least time of the orderings ``shapes``, a list of (m, d, batch)."""
    total = 0.0
    for m, d, batch in shapes:
        ops, nbytes = ordering_work(m, d, batch)
        total += least_seconds(ops, nbytes, sfu_per_s, bytes_per_s)
    return total
