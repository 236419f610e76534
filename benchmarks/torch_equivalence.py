"""Paper Fig. 3 on the port: parallel and sequential DirectLiNGAM give the
same causal order, and both recover the simulated DAG (F1 / recall / SHD
over N seeds; the paper uses 50 sims of m=10000, d=10).

    PYTHONPATH=src python3 -m benchmarks.torch_run --only equivalence [--full]

The parallel side is ``repro_torch``'s DirectLiNGAM on ``device`` (the
CUDA kernel on the card); the sequential side is the numpy pair loop on
the host. Equally valid roots (independent variables of one layer) score
0 up to rounding, so the two may part at such a tie: :func:`parting_tie`
replays the port's scan to the first parting and holds the two roots'
scores within the tolerance that fp32 moments allow. This module also
holds the F1 / recall / SHD measure the other port benches use.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.baselines import sequential_lingam as seq
from repro_torch.core import DirectLiNGAM, api, measures, ordering
from repro_torch.data.simulate import simulate_lingam

# Pairwise-moment tolerance of the kernel against its plain version (the
# reference's own kernel tolerance): the moment error a tie may carry.
ATOL_MOMENTS = 2e-6


def f1_rec_shd(b_est, b_true, thresh=0.1):
    e = np.abs(b_est) > thresh
    t = b_true != 0
    tp = np.sum(e & t)
    fp = np.sum(e & ~t)
    fn = np.sum(~e & t)
    prec = tp / max(tp + fp, 1)
    rec = tp / max(tp + fn, 1)
    f1 = 2 * prec * rec / max(prec + rec, 1e-12)
    return f1, rec, fp + fn


def score_tolerance(cm1, cm2, m1, m2, active, atol, col_atol=0.0):
    """Per-variable bound on how far a k_list score can move when every
    pairwise moment moves by at most ``atol`` and every column moment by
    at most ``col_atol`` (0: the column moments are shared).
    H = H0 - K1 (m1 - g)^2 - K2 m2^2 moves by at most
    2 K1 |m1 - g| a + K1 a^2 + 2 K2 |m2| a + K2 a^2; a pair's MI
    difference by the sum of its four entropies' moves; and a score term
    min(0, diff)^2 by 2 |min(0, diff)| e + e^2."""

    def entropy_move(g1, g2, a):
        return (2 * measures.K1 * (g1 - measures.GAMMA).abs() * a
                + measures.K1 * a**2 + 2 * measures.K2 * g2.abs() * a
                + measures.K2 * a**2)

    m1, m2 = m1.double(), m2.double()
    cm1, cm2 = cm1.double(), cm2.double()
    dh = entropy_move(m1, m2, atol)
    dc = entropy_move(cm1, cm2, col_atol)
    h_col = measures.entropy_from_moments(cm1, cm2)
    h_res = measures.entropy_from_moments(m1, m2)
    diff = (h_col[None, :] + h_res) - (h_col[:, None] + h_res.T)
    e = dh + dh.T + dc[None, :] + dc[:, None]
    eye = torch.eye(len(active), dtype=torch.bool, device=active.device)
    pair_ok = active[:, None] & active[None, :] & ~eye
    term = 2 * torch.clamp(diff, max=0.0).abs() * e + e * e
    return torch.where(pair_ok, term, 0.0).sum(dim=1)


def parting_tie(x, order_a, order_b, reducer, atol=ATOL_MOMENTS):
    """Replay the masked scan on ``x`` along ``order_a`` up to the first
    position p where ``order_b`` parts from it, and compare the two roots'
    scores there. Returns (p, the score gap over the score tolerance that
    moments moved by ``atol`` allow); (None, 0.0) for equal orders. A
    ratio above 1 means the orders part where the scores do not tie."""
    parts = np.nonzero(np.asarray(order_a) != np.asarray(order_b))[0]
    if not len(parts):
        return None, 0.0
    p = int(parts[0])
    active = torch.ones(x.shape[1], dtype=torch.bool, device=x.device)
    for step in range(p):
        root = torch.tensor(int(order_a[step]), device=x.device)
        _, _, mu, var = ordering.step_standardize(x, reducer)
        x, active = ordering.residualize(x, active, root, mu, var, reducer)
    x_std, c, _, _ = ordering.step_standardize(x, reducer)
    cm = reducer.col_moments(x_std)
    m1, m2 = reducer.moment_rows(x_std, c)
    scores = ordering.step_scores(*cm, m1, m2, active)
    tol = score_tolerance(*cm, m1, m2, active, atol)
    a, b = int(order_a[p]), int(order_b[p])
    gap = abs(float(scores[a] - scores[b]))
    return p, gap / float(tol[a] + tol[b])


def run(quick: bool = True, n_sims: int | None = None, device="cuda"):
    device = api.resolve_device(device)
    n = n_sims or (10 if quick else 50)
    m, d = (3_000, 8) if quick else (10_000, 10)
    matches, f1s, recs, shds, ratios = 0, [], [], [], [0.0]
    for s in range(n):
        gt = simulate_lingam(m=m, d=d, seed=s)
        o_seq = seq.causal_order_sequential(gt.data)
        model = DirectLiNGAM(prune_threshold=0.1, device=device).fit(gt.data)
        if np.array_equal(o_seq, model.causal_order_):
            matches += 1
        else:
            x = torch.tensor(np.ascontiguousarray(gt.data), device=device)
            ratios.append(parting_tie(x, model.causal_order_, o_seq,
                                      ordering.LocalReducer())[1])
        f1, rec, shd = f1_rec_shd(model.adjacency_, gt.adjacency)
        f1s.append(f1)
        recs.append(rec)
        shds.append(shd)
    res = {
        "n_sims": n, "m": m, "d": d, "device": str(device),
        "order_match_rate": matches / n,
        "parting_gap_ratio_max": float(max(ratios)),
        "f1_mean": float(np.mean(f1s)), "f1_std": float(np.std(f1s)),
        "recall_mean": float(np.mean(recs)),
        "shd_mean": float(np.mean(shds)), "shd_std": float(np.std(shds)),
    }
    print(
        f"torch_equivalence,n={n},order_match={res['order_match_rate']:.2f},"
        f"parting_gap_ratio_max={res['parting_gap_ratio_max']:.3f},"
        f"f1={res['f1_mean']:.3f}+-{res['f1_std']:.3f},"
        f"recall={res['recall_mean']:.3f},shd={res['shd_mean']:.2f}"
    )
    return res
