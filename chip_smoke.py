#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one CUDA card and check it.

    python3 chip_smoke.py

Imports only ``repro_torch`` (from ``src/``), ``torch`` and numpy. Phases,
any failure of which exits non-zero:

  1. device: the card's name and power limit, the TF32 flag; build the
     CUDA kernel from ``src/repro_torch/kernels/csrc`` with nvcc;
  2. the kernel against its plain-torch version on the card: the test
     shapes at atol 2e-6, one full-size step (m = 1,000,000, d = 100)
     against the plain version in float64, and two launches bit-identical;
  3. mid-size fits (m = 20,000, d = 32): the kernel against the plain
     ``blocked`` backend, both on the card: on a layered DAG, step by step
     up to ties between equally valid roots; on a chain DAG, whose order
     is unique, exactly;
  4. the full-size fit, workload ``lingam-1m-100``, with compaction
     "none" and "staged": equal orders, consistent with the true DAG, the
     kernel launched once per ordering step;
  5. one JSON line listing every ported kernel with its launches, error,
     times and bound;
  6. last line: {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# Off-diagonal moment tolerance against the fp32 plain version: the
# reference's own kernel tolerance (tests/test_kernels.py).
ATOL_F32 = 2e-6
# Against the float64 plain version at m = 1e6: fp32 sums over ~7,800
# 128-sample sub-sums (in 22 splits) carry ~1e-6 relative rounding; the
# means are O(0.4), so 1e-5 absolute leaves a margin of several times.
ATOL_F64_FULL = 1e-5
# Adjacency of two fits with equal orders: the backends' moments differ
# only in fp32 summation order, and the adjacency does not depend on them.
ATOL_ADJ = 1e-5
TEST_SHAPES = [(64, 4), (100, 5), (257, 10), (511, 16), (1000, 33),
               (2048, 64), (4096, 130), (777, 40)]
N_SPLITS = (1, 3, 7)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 peak memory rate
SFU_OPS_PER_CLOCK_PER_SM = 16
SFU_OPS_PER_TERM = 3  # exp(-2|u|), log1p(.), exp(-u^2/2)


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", flush=True)
    sys.exit(1)


def smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def offdiag_err(a, b):
    d = a.shape[0]
    mask = ~np.eye(d, dtype=bool)
    return float(np.max(np.abs(a.cpu().double().numpy()
                               - b.cpu().double().numpy())[mask]))


def score_tolerance(cm1, cm2, m1, m2, active, atol):
    """Per-variable bound on how far a k_list score can move when every
    pairwise moment moves by at most ``atol`` (the column moments are
    shared). H = H0 - K1 (m1 - g)^2 - K2 m2^2 moves by at most
    2 K1 |m1 - g| a + K1 a^2 + 2 K2 |m2| a + K2 a^2; a pair's MI
    difference by the sum of its two residual entropies' moves; and a
    score term min(0, diff)^2 by 2 |min(0, diff)| e + e^2."""
    import torch

    from repro_torch.core import measures

    m1, m2 = m1.double(), m2.double()
    dh = (2 * measures.K1 * (m1 - measures.GAMMA).abs() * atol
          + measures.K1 * atol**2 + 2 * measures.K2 * m2.abs() * atol
          + measures.K2 * atol**2)
    h_col = measures.entropy_from_moments(cm1.double(), cm2.double())
    h_res = measures.entropy_from_moments(m1, m2)
    diff = (h_col[None, :] + h_res) - (h_col[:, None] + h_res.T)
    e = dh + dh.T
    eye = torch.eye(len(active), dtype=torch.bool, device=active.device)
    pair_ok = active[:, None] & active[None, :] & ~eye
    term = 2 * torch.clamp(diff, max=0.0).abs() * e + e * e
    return torch.where(pair_ok, term, 0.0).sum(dim=1)


def walk_against_plain(x, kernel, plain, atol):
    """Replay the kernel fit's masked scan on ``x``. At every step the
    plain backend's moments must agree with the kernel's within ``atol``
    off the diagonal, and the plain backend's scores must rank the
    kernel's root best within the score tolerance that ``atol`` implies.
    Valid roots that are independent of each other score 0 up to fp32
    rounding, so two correct backends may break such ties differently.
    Returns (order, worst moment error, number of tied steps, the largest
    ratio of a tied step's score gap to its tolerance)."""
    import torch

    from repro_torch.core import ordering

    d = x.shape[1]
    active = torch.ones(d, dtype=torch.bool, device=x.device)
    off = ~torch.eye(d, dtype=torch.bool, device=x.device)
    order, worst, tied, ratio = [], 0.0, 0, 0.0
    for step in range(d):
        x_std, c, _, _ = ordering.step_standardize(x, kernel)
        cm = kernel.col_moments(x_std)
        k1, k2 = kernel.moment_rows(x_std, c)
        p1, p2 = plain.moment_rows(x_std, c)
        worst = max(worst, float((k1 - p1)[off].abs().max()),
                    float((k2 - p2)[off].abs().max()))
        s_kernel = ordering.step_scores(*cm, k1, k2, active)
        s_plain = ordering.step_scores(*cm, p1, p2, active)
        tol = score_tolerance(*cm, p1, p2, active, atol)
        root, best = int(s_kernel.argmax()), int(s_plain.argmax())
        if root != best:
            tied += 1
            gap = float(s_plain[best] - s_plain[root])
            ratio = max(ratio, gap / float(tol[root] + tol[best]))
            if gap > float(tol[root] + tol[best]):
                fail(f"step {step}: plain scores rank root {best} above the "
                     f"kernel's {root} by {gap:.3e}, beyond the tolerance")
        x, active, r = ordering.ordering_step(x, active, kernel)
        if int(r) != root:
            fail(f"step {step}: replay picked {int(r)}, expected {root}")
        order.append(root)
    return np.array(order), worst, tied, ratio


def order_consistent(order, b_true) -> bool:
    """No true edge may point from a later to an earlier variable."""
    d = len(order)
    pos = np.empty(d, int)
    pos[np.asarray(order)] = np.arange(d)
    src, dst = np.nonzero(b_true)  # b[i, j] != 0: j -> i
    return bool(np.all(pos[dst] < pos[src]))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on the card",
              file=sys.stderr)
        return 1

    from repro_torch.configs.lingam_workloads import WORKLOADS
    from repro_torch.core import DirectLiNGAM, api, ordering
    from repro_torch.data.simulate import simulate_lingam
    from repro_torch.kernels import build, ops, pairwise_stats

    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    def cuda_ms(fn, reps):
        """Median ms of ``fn`` over ``reps`` runs, timed with CUDA events."""
        times = []
        for _ in range(reps):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            torch.cuda.synchronize()
            times.append(e0.elapsed_time(e1))
        return float(np.median(times))

    # 1. device and build
    print(smi("name,power.limit"), flush=True)
    print(f"device: {torch.cuda.get_device_name(0)}, torch {torch.__version__}"
          f", cuda {torch.version.cuda}, tf32 matmul: {api.tf32_enabled()}")
    if api.tf32_enabled():
        fail("TF32 matmuls are on; the fit needs full-fp32 correlations")
    clock_mhz = float(smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"SMs: {sms}, max SM clock: {clock_mhz} MHz")
    build.load("pairwise_moments")
    info = build.build_info["pairwise_moments"]
    print(f"build: pairwise_moments.cu in {info['seconds']:.2f} s")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    # 2. kernel against its plain version on the card
    rng = np.random.default_rng(42)
    worst = 0.0
    for m, d in TEST_SHAPES:
        x = torch.from_numpy(rng.laplace(size=(m, d)).astype(np.float32))
        xs = ops.standardize(x.to(dev))
        c = ops.correlation(xs).contiguous()
        for n_split in (None, *N_SPLITS):
            k1, k2 = pairwise_stats.pairwise_moments(xs, c, n_split=n_split)
            p1, p2 = pairwise_stats.pairwise_moment_sums_plain(
                xs, c, n_split=n_split)
            inv_m = float(np.float32(1.0 / m))
            err = max(offdiag_err(k1, p1 * inv_m), offdiag_err(k2, p2 * inv_m))
            ok = bool(torch.isfinite(k1).all() and torch.isfinite(k2).all())
            print(f"kernel vs plain (m={m}, d={d}, n_split={n_split}): "
                  f"max off-diagonal err {err:.3e}, finite {ok}")
            if not ok or err > ATOL_F32:
                fail(f"kernel disagrees at ({m}, {d}, {n_split}): {err}")
            worst = max(worst, err)

    wl = WORKLOADS["lingam-1m-100"]
    gt = simulate_lingam(m=wl.m, d=wl.d, seed=0)
    x_full = torch.from_numpy(np.ascontiguousarray(gt.data)).to(dev)
    x_std, c, _, _ = ordering.step_standardize(
        x_full, ordering.LocalReducer())
    m, d = x_std.shape
    a1, a2 = ops.pairwise_moments(x_std, c)
    b1, b2 = ops.pairwise_moments(x_std, c)
    torch.cuda.synchronize()
    identical = torch.equal(a1, b1) and torch.equal(a2, b2)
    print(f"full-size step (m={m}, d={d}): two launches bit-identical: "
          f"{identical}")
    if not identical:
        fail("two launches of the kernel differ")
    t0 = time.perf_counter()
    q1, q2 = pairwise_stats.pairwise_moment_sums_plain(
        x_std.double(), c.double())
    torch.cuda.synchronize()
    full_err = max(offdiag_err(a1, q1 / m), offdiag_err(a2, q2 / m))
    print(f"full-size step vs float64 plain version: max off-diagonal err "
          f"{full_err:.3e} (tolerance {ATOL_F64_FULL}), float64 plain "
          f"{time.perf_counter() - t0:.1f} s")
    if not (full_err <= ATOL_F64_FULL and torch.isfinite(a1).all()
            and torch.isfinite(a2).all()):
        fail(f"full-size kernel error {full_err} > {ATOL_F64_FULL}")
    del q1, q2
    kernel_ms = cuda_ms(lambda: ops.pairwise_moments(x_std, c), 10)
    plain_ms = cuda_ms(
        lambda: pairwise_stats.pairwise_moment_sums_plain(x_std, c), 2)
    ops_ms = SFU_OPS_PER_TERM * d * d * m / (
        sms * SFU_OPS_PER_CLOCK_PER_SM * clock_mhz * 1e6) * 1e3
    bytes_ms = 4 * (m * d + d * d + 2 * d * d) / HBM_BYTES_PER_S * 1e3
    bound_ms = max(ops_ms, bytes_ms)
    print(f"kernel at (m={m}, d={d}): {kernel_ms:.3f} ms per launch "
          f"(median of 10, CUDA events); plain version {plain_ms:.1f} ms; "
          f"bound {bound_ms:.3f} ms (special-function ops {ops_ms:.3f} ms, "
          f"bytes {bytes_ms:.3f} ms)")
    del x_std, c, a1, a2, b1, b2

    # 3. mid-size fit: kernel against the plain blocked backend. The
    # layered DAG has many independent, equally valid roots whose scores
    # are 0 up to fp32 rounding; where the two backends break such a tie
    # differently their orders part, so the step-by-step replay holds the
    # kernel's choices against the plain scores within the tolerance.
    gt_mid = simulate_lingam(m=20_000, d=32, seed=0)
    fit_k = DirectLiNGAM().fit(gt_mid.data)
    fit_b = DirectLiNGAM(backend="blocked").fit(gt_mid.data)
    same = np.array_equal(fit_k.causal_order_, fit_b.causal_order_)
    adj_err = float(np.max(np.abs(fit_k.adjacency_ - fit_b.adjacency_)))
    ok_k = order_consistent(fit_k.causal_order_, gt_mid.adjacency)
    ok_b = order_consistent(fit_b.causal_order_, gt_mid.adjacency)
    replay, mid_err, tied, ratio = walk_against_plain(
        torch.from_numpy(np.ascontiguousarray(gt_mid.data)).to(dev),
        ordering.LocalReducer(), ordering.LocalReducer(backend="blocked"),
        ATOL_F32)
    print(f"mid-size fit (m=20000, d=32): orders equal {same}, adjacency "
          f"max diff {adj_err:.3e}; both consistent with the true DAG "
          f"{ok_k and ok_b}; replay: moments max off-diagonal err "
          f"{mid_err:.3e}, {tied} of 32 steps broke a tie differently, "
          f"largest score gap {ratio:.3f} of its tolerance")
    if not (ok_k and ok_b) or mid_err > ATOL_F32:
        fail("kernel and blocked fits disagree at (20000, 32)")
    if not np.array_equal(replay, fit_k.causal_order_):
        fail("the replay does not reproduce the kernel fit's order")
    if same and adj_err > ATOL_ADJ:
        fail(f"equal orders but adjacency differs by {adj_err}")
    # A chain DAG (one variable per layer, every edge present) has a single
    # valid order, with top-2 score gaps ~1e-3: there the fits must agree
    # exactly.
    gt_chain = simulate_lingam(m=20_000, d=32, n_layers=32, edge_prob=1.0,
                               seed=0)
    fit_k = DirectLiNGAM().fit(gt_chain.data)
    fit_b = DirectLiNGAM(backend="blocked").fit(gt_chain.data)
    adj_err = float(np.max(np.abs(fit_k.adjacency_ - fit_b.adjacency_)))
    same = (np.array_equal(fit_k.causal_order_, fit_b.causal_order_)
            and np.array_equal(fit_k.causal_order_, gt_chain.order))
    print(f"mid-size chain fit (m=20000, d=32): orders equal to each other "
          f"and to the true order {same}, adjacency max diff {adj_err:.3e}")
    if not same or adj_err > ATOL_ADJ:
        fail("kernel and blocked fits disagree on the chain DAG")

    # 4. full-size fit: the main path
    fits = {}
    for compaction in ("none", "staged"):
        pairwise_stats.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model = DirectLiNGAM(compaction=compaction).fit(gt.data)
        fit_s = time.perf_counter() - t0
        n_launch = pairwise_stats.launches
        consistent = order_consistent(model.causal_order_, gt.adjacency)
        finite = bool(np.isfinite(model.adjacency_).all()
                      and np.isfinite(model.resid_var_).all())
        fits[compaction] = (model, n_launch)
        print(f"full-size fit {wl.name} (m={wl.m}, d={wl.d}), compaction "
              f"{compaction!r}: {fit_s:.3f} s, kernel launches {n_launch}, "
              f"order consistent with the true DAG {consistent}, "
              f"finite {finite}")
        if n_launch != wl.d:
            fail(f"expected {wl.d} kernel launches, got {n_launch}")
        if not (consistent and finite):
            fail(f"full-size fit ({compaction}) is wrong")
    if not np.array_equal(fits["none"][0].causal_order_,
                          fits["staged"][0].causal_order_):
        fail("compaction 'none' and 'staged' give different orders")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ordering.causal_order(x_full).cpu()
    print(f"full-size ordering alone (compaction 'none'): "
          f"{time.perf_counter() - t0:.3f} s")

    # 5. kernels line
    print(json.dumps({"kernels": [{
        "name": "pairwise_moments",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/pairwise_moments.cu",
        "replaces": "src/repro/kernels/pairwise_stats.py:80",
        "launches": fits["none"][1],
        "max_abs_err": full_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "library_ms": None,
    }]}))
    print(f"chip_smoke: all phases passed in "
          f"{time.perf_counter() - t_start:.1f} s (test shapes worst err "
          f"{worst:.3e})")

    # 6. last line
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
