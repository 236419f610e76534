"""The comparison that decides ``correct``.

An *answer* is one fit the program returned in the window, with the raw
data it was fitted on (as the benchmark made it and handed it in). The
reference judges each answer from that data alone. A cell compares the
numbers its limits file names:

* ``order_gap`` -- the reference replays the program's causal order on
  the data (for a VarLiNGAM answer, on its own VAR residuals) and records,
  at every step, how far the chosen variable's score lies below the best
  score of the step; the number is the widest such gap. Variables that
  are equally valid roots score alike up to rounding, so a program that
  breaks such a tie otherwise reads a gap at the rounding level; a wrong
  root reads the score difference of a real dependence.
* ``resid_var_err`` -- max_i |v_i - v_ref,i| / v_ref,i over the residual
  variances, v_ref from the reference's own ordering and least squares.
  Swapping equally valid roots moves a residual variance by about the
  squared sample correlation of independent variables (1/m); a wrong
  root moves it by a real dependence; wrong coefficients raise it.
* ``adjacency_err`` -- max |B - B_ref| / max |B_ref|, where B_ref is the
  reference's least-squares adjacency for the program's order.
* ``var_coef_err`` (VarLiNGAM answers) -- the same for the lag-1 VAR
  coefficient matrix against the reference's float64 least squares.

A cell's number is the largest over its answers. An ordering (the replay
or the reference's own) costs what a fit costs; the other numbers are
cheap, so a cell may order a sample of its answers (``replay=False`` on
the others) and check every answer's adjacency. :func:`control` puts the
reference itself, in a lower precision, in the program's place.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Dict, Iterable, List, Optional

import numpy as np
import torch

from . import reference

ORDERED = ("order_gap", "resid_var_err")   # numbers that need an ordering


@dataclasses.dataclass
class Answer:
    kind: str                      # "direct" | "var"
    data: np.ndarray               # the raw (m, d) float32 data
    order: Optional[np.ndarray] = None
    adjacency: Optional[np.ndarray] = None   # B (direct) or B0 (var)
    var_coefs: Optional[np.ndarray] = None   # lag-1 VAR matrix (var)
    resid_var: Optional[np.ndarray] = None   # residual variances (direct)
    lags: int = 1
    replay: bool = True            # False: the cheap numbers only


def _fit_data(answer: Answer, mode: str, device):
    """The data DirectLiNGAM orders (the residuals for a VarLiNGAM
    answer), as a tensor, and the VAR matrices (None for direct)."""
    if answer.kind == "var":
        mats, _, resid = reference.var_lstsq(answer.data, answer.lags, mode)
        return torch.as_tensor(resid, device=device), mats
    return torch.as_tensor(answer.data, device=device), None


def _applies(name: str, answer: Answer) -> bool:
    if name in ORDERED:
        return answer.replay
    if name == "var_coef_err":
        return answer.kind == "var"
    return name == "adjacency_err"


def judge_one(answer: Answer, device, wanted: Iterable[str]
              ) -> Dict[str, float]:
    """The wanted numbers of one answer; an answer the program never
    gave, or one that is not an order of the variables, gives none (and
    fails)."""
    wanted = {n for n in wanted if _applies(n, answer)}
    out = {}
    if answer.order is None or answer.adjacency is None:
        print("judge: no answer", file=sys.stderr)
        return out
    x, mats = _fit_data(answer, "reference", device)
    order = np.asarray(answer.order)
    if sorted(order.tolist()) != list(range(x.shape[1])):
        print("judge: the order is not a permutation", file=sys.stderr)
        return out
    cov = reference.covariance(x)
    if "order_gap" in wanted:
        _, gaps = reference.walk(x, "reference", order=order)
        out["order_gap"] = float(gaps.max())
    if "resid_var_err" in wanted and answer.resid_var is not None:
        own, _ = reference.walk(x, "reference")
        want = reference.resid_var(cov, reference.ols_adjacency(cov, own))
        out["resid_var_err"] = float(np.max(
            np.abs(np.asarray(answer.resid_var, dtype=np.float64) - want)
            / want))
    if "adjacency_err" in wanted:
        b_ref = reference.ols_adjacency(cov, order)
        out["adjacency_err"] = reference.rel_err(answer.adjacency,
                                                 b_ref.cpu().numpy())
    if "var_coef_err" in wanted:
        out["var_coef_err"] = reference.rel_err(answer.var_coefs, mats[0])
    return out


def judge(answers: List[Answer], device, wanted: Iterable[str]
          ) -> Dict[str, float]:
    """Each wanted number's largest reading over the answers it applies
    to; a number is left out (and so fails) where an answer it applies to
    does not give it."""
    wanted = set(wanted)
    per = [(a, judge_one(a, device, wanted)) for a in answers]
    out = {}
    for n in wanted:
        should = [p for a, p in per if _applies(n, a)]
        if should and all(n in p for p in should):
            out[n] = max(p[n] for p in should)
    return out


def control(answer: Answer, mode: str, device) -> Answer:
    """The answer the reference itself gives in ``mode``, in the
    program's place: its own VAR, order, adjacency and residual
    variances."""
    x, mats = _fit_data(answer, mode, device)
    x = x.float()
    order, _ = reference.walk(x, mode)
    b = reference.ols_adjacency(reference.covariance(x, mode), order, mode)
    return dataclasses.replace(
        answer, order=order, adjacency=b.cpu().numpy(),
        var_coefs=None if mats is None else mats[0],
        resid_var=reference.resid_var_from_data(x, b, mode))
