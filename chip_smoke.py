#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one CUDA card and check them.

    python3 chip_smoke.py

Imports only ``repro_torch`` (from ``src/``), the port's benchmarks
(``benchmarks/torch_*.py``), ``torch``, numpy and scipy. Phases, any
failure of which exits non-zero:

  1. device: the card's name and power limit, the TF32 flag; build the
     CUDA kernels from ``src/repro_torch/kernels/csrc`` with nvcc, one
     process per source, all at once, and read each kernel's registers
     and spills from the ptxas report;
  2. kernel B1 (``pairwise_moments``) against its plain-torch version on
     the card: the test shapes at atol 2e-6, one full-size step
     (m = 1,000,000, d = 100) against the plain version in float64, and
     two launches bit-identical; width invariance (the leading 75 and 56
     columns of that step, the leading 243 of a 487-wide X, bit for bit
     the full launch's pairs); B1 timed at (1e6, 100) and at the
     VarLiNGAM shape (3999, 487);
  3. kernel B2 (``pairwise_moment_sums_rows``) against its plain version:
     the reference's padding-edge cells with and without a row offset, and
     the rolling stream's shape (a 2048 x 487 window in 256-row slabs)
     against float64; two launches bit-identical; the slab-structured
     launch (one per ordering step) equal bit for bit to the per-slab
     launches added in order, at the window and at a ragged 2000 rows,
     and timed for one window step;
  4. kernel B3 (``fused_moment_sums``) against its plain version in
     float32 and bfloat16, at the edge cells and at (1e6, 100) against
     float64, and bit-equal to B1/B2 on the same standardized values; then
     its entry point ``ops.fused_moment_rows`` once in each type;
  5. mid-size fits (m = 20,000, d = 32): the kernel against the plain
     ``blocked`` backend, both on the card: on a layered DAG, step by step
     up to ties between equally valid roots; on a chain DAG, whose order
     is unique, exactly;
  6. the full-size fit, workload ``lingam-1m-100``, with compaction
     "none" and "staged": equal orders, consistent with the true DAG, the
     kernel launched once per ordering step;
  7. the VarLiNGAM facade at ``varlingam-stocks-487`` (m = 4000,
     d = 487): B1 once per step, walked step by step against ``blocked``;
  8. the rolling stream ``varlingam-stream-487`` through a
     ``StreamSession``: 12 chunks of 256 rows, 5 refits (4 after a
     retraction), each held against the from-scratch window fit, one
     walked against ``blocked``, compactions "staged" and "none" equal;
     B2 launched once per ordering step; the last window refit three
     more times untraced for its wall time and once under
     ``torch.profiler`` for B2's kernel time and the device's busy time:
     the idle share is taken over the untraced wall time;
  9. the bootstrap at the stock panel's width (m = 4000, d = 487, 32
     resamples, compaction "staged"): first the batch grid axis of B1/B2,
     a batched launch bit-equal to the launches on each element (B1 at
     4 x (4000, 487), at width 243 and at m = 3999; the slab launch at
     2 x 2048 rows in 8 slabs) and batched B1 against its batched plain
     version at the test shapes; then ``bootstrap_lingam`` with
     ``strategy="auto"`` (which must pick "vmap": one B1 launch per
     ordering step, 487 for all 32 resamples) against ``"loop"`` (32 x
     487) on the same indices: orders equal per resample up to ties,
     equal edge probabilities, coefficient statistics within 1e-5; the
     peak device memory of each strategy, and the "auto" rule's peak
     model between 1 and 1.5 times the measured vmap peak; ``bootstrap_effects`` against
     the loop's fits' total effects, and those effects (the card's
     triangular solves) against float64 ``(I - B)^-1`` within the
     solve's componentwise error bound; the vmap bootstrap again under
     ``torch.profiler`` for its idle share (over the untraced run); B1
     at the batched shape (32, 4000, 487) against its plain version in
     float64, and timed;
 10. the serving engine (``CausalDiscoveryEngine``, batch 8) at the
     stock panel's width: its warm-up with ``tune_mode="auto"`` (the
     tuning overlay in a temporary directory) searches the pair-block
     edge T of B1 at (4000, 487) and of B2 at the stream window (2048 x
     487 in slabs of 256), every candidate bit-equal, and a second
     warm-up measures nothing; a burst of 8 fit requests at (4000, 487)
     and 3 at (20,000, 100), one ``fit_many`` per shape, each result
     against ``api.fit_fn`` on that request alone (orders up to ties,
     adjacency within 1e-5); 8 monitored sessions at
     ``varlingam-stream-487`` posted 12 chunks round robin, session 3
     with a noise-scale break after its window fills: every auto-flush
     one ``fit_many_from_stats`` per window shape with one B2 launch per
     ordering step, the last flush of all 8 traced for its idle share
     and held against each session's own refit, seconds per monitored
     post, the break alerted on its variable and each alert delivered
     once by ``poll_alerts``; 16 mixed effect, intervention and RCA
     queries against the fit results and session ids, each against the
     direct function on its graph (effects and interventions within 1e-5
     of max(1, |answer|)), the effects against float64 ``(I - B)^-1`` and
     the RCA scores and contributions, batched and direct, against float64
     within their componentwise bounds;
 11. one JSON line listing every ported kernel with its launches on its
     path, error, times, bound and ptxas registers and spills (printed
     after phase 12, whose B1 launches and gene-shape time it carries);
 12. the paper's experiments through the port's benchmarks, on the card:
     (a) the speed-up, the sequential numpy pair loop on the host against
     the kernel ordering (medians of 3) on the quick grid and (10,000,
     64), orders equal or parting only at a tie, one B1 launch per step;
     (b) paper Fig. 3, 10 simulations of (3000, 8): order match against
     the sequential loop, F1 >= 0.9 on average; (c) NOTEARS, GOLEM and
     ICA-LiNGAM at (2000, 10), each one's working operations seen on the
     card by a torch function mode, F1/SHD printed, ICA-LiNGAM held to
     F1 > 0.7; (d) the gene study at m = 50,000, d = 961 (Table 1): fit
     seconds, B1 launches, I-NLL/I-MAE finite, peak memory, and B1 at the
     fit's first step timed against its bound, a 64-row tile against
     float64; (e) VarLiNGAM on the 487-stock panel (Fig. 4): seconds,
     b0 precision and recall;
 13. last line: {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# Off-diagonal moment tolerance against the fp32 plain version: the
# reference's own kernel tolerance (tests/test_kernels.py).
ATOL_F32 = 2e-6
# Against the float64 plain version at m = 1e6: fp32 sums over ~7,800
# 128-sample sub-sums (in 127 splits) carry ~1e-6 relative rounding; the
# means are O(0.4), so 1e-5 absolute leaves a margin of several times.
ATOL_F64_FULL = 1e-5
# Adjacency of two fits with equal orders: the backends' moments differ
# only in fp32 summation order, and the adjacency does not depend on them.
ATOL_ADJ = 1e-5
TEST_SHAPES = [(64, 4), (100, 5), (257, 10), (511, 16), (1000, 33),
               (2048, 64), (4096, 130), (777, 40)]
N_SPLITS = (1, 3, 7)
# Row-tile (tile, d, m) cells straddling the reference's block multiples
# (tests/test_kernels.py _EDGE_CELLS). Sums are held per sample: the
# reference's tolerances, 2e-6 * m for B2 and 4e-6 * m for B3.
EDGE_CELLS = [(7, 9, 127), (8, 16, 129), (9, 15, 255), (8, 17, 257),
              (16, 16, 128)]
ATOL_ROWS = 2e-6
ATOL_FUSED = 4e-6
# A float32 unit-triangular solve T = L^-1 against float64: componentwise
# |T32 - T| <= gamma_d |T| |L| |T32|, gamma_d = d u / (1 - d u), u = 2^-24
# (Higham, Accuracy and Stability of Numerical Algorithms, Thm 8.5);
# plus an absolute 1e-9 for the float64 inverse's own rounding where T is
# zero by structure.
SOLVE_ABS_FLOOR = 1e-9
# Thetas and adjacency of a rolling refit against the from-scratch window
# fit with the same order (tests/test_stream.py).
ATOL_STREAM = 1e-4
# The bootstrap's "auto" memory model against its measured peak: an upper
# bound, over by at most half.
PEAK_MODEL_MARGIN = 1.5
# Served effect and intervention answers (batched triangular solves)
# against the same function on one graph: max |a - b| <= ATOL_QUERY *
# max(1, max |b|) per answer; a batched and a single solve round
# differently on the card (1.14e-05 at |T| = 31.5). RCA answers (products
# over d terms with cancellation) are held to float64 within their
# componentwise rounding bounds instead.
ATOL_QUERY = 1e-5
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 peak memory rate
SFU_OPS_PER_CLOCK_PER_SM = 16
SFU_OPS_PER_TERM = 3  # ex2 (exp(-2|u|)), lg2 (log1p), ex2 (exp(-u^2/2))
# Phase 12's speed-up grid: the reference's quick grid and this shape of
# its full grid.
SPEEDUP_WIDE = (10_000, 64)


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", flush=True)
    sys.exit(1)


def smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def ptxas_report(log: str):
    """{kernel entry: {"registers", "spill_stores", "spill_loads"}} from
    an ``nvcc -Xptxas -v`` log, one entry per compiled kernel instance."""
    names = (("pair_partials_kernelILi4E", "pair_partials<4>"),
             ("pair_partials_kernelILi2E", "pair_partials<2>"),
             ("pair_partials_kernelILi1E", "pair_partials<1>"),
             ("reduce_slabs_kernel", "reduce_slabs"),
             ("fused_partials_kernelIfE", "fused_partials<float>"),
             ("fused_partials_kernelI13__nv_bfloat16E",
              "fused_partials<bfloat16>"),
             ("reduce_splits_kernel", "reduce_splits"))
    report, entry = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = next((short for key, short in names if key in line), None)
            if entry:
                report[entry] = {}
        elif entry and "spill stores" in line:
            words = line.replace(",", " ").split()
            report[entry]["spill_stores"] = int(words[words.index("spill") - 2])
            report[entry]["spill_loads"] = int(words[-4])
        elif entry and "registers" in line:
            words = line.replace(",", " ").split()
            report[entry]["registers"] = int(words[words.index("registers")
                                                   - 1])
    return report


def device_busy(fn):
    """Run ``fn`` once under torch.profiler. Returns (wall s, device busy
    s, {kernel name: device s}): busy is the union of the device's
    activity intervals (kernels, copies, sets). If the trace holds no
    device activity, busy and the per-kernel times are None."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    if not spans:
        return wall, None, None
    busy, end, per_kernel = 0.0, float("-inf"), {}
    for start, stop, name in spans:
        per_kernel[name] = per_kernel.get(name, 0.0) + (stop - start) * 1e-6
        if stop > end:
            busy += (stop - max(start, end)) * 1e-6
            end = stop
    return wall, busy, per_kernel


def offdiag_err(a, b, row0=0):
    """Largest |a - b| off the diagonal of a (rows, d) row tile that
    starts at row ``row0`` (the pair (i, row0 + i) is undefined)."""
    rows, d = a.shape
    mask = ~np.eye(rows, d, k=row0, dtype=bool)
    return float(np.max(np.abs(a.cpu().double().numpy()
                               - b.cpu().double().numpy())[mask]))


def moment_bound_ms(rows, d, m, n_bytes, sms, clock_mhz):
    """(bound, by operations, by bytes) in ms for the moment sums of a
    (rows, d) pair tile over m samples: SFU_OPS_PER_TERM special-function
    ops per (pair, sample) over the SMs' rate, against ``n_bytes`` (each
    input read once, each output written once) over the memory rate."""
    ops_ms = SFU_OPS_PER_TERM * rows * d * m / (
        sms * SFU_OPS_PER_CLOCK_PER_SM * clock_mhz * 1e6) * 1e3
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), ops_ms, bytes_ms


def walk_against_plain(x, kernel, plain, atol, x_plain=None):
    """Replay the kernel fit's masked scan on ``x``. At every step the
    plain backend's moments must agree with the kernel's within ``atol``
    off the diagonal, and the plain backend's scores must rank the
    kernel's root best within the score tolerance that ``atol`` implies.
    Valid roots that are independent of each other score 0 up to fp32
    rounding, so two correct backends may break such ties differently.

    With ``x_plain`` (data that should agree with ``x`` to rounding, e.g.
    a from-scratch window's residuals beside the rolling ones) the plain
    side runs on ``x_plain``, residualized along the kernel's roots, and
    each step's tolerance is the larger of ``atol`` and the moment
    differences measured at that step, the column moments included.
    Returns (order, worst moment difference, number of tied steps, the
    largest ratio of a tied step's score gap to its tolerance)."""
    import torch

    from benchmarks.torch_equivalence import score_tolerance
    from repro_torch.core import ordering

    d = x.shape[1]
    active = torch.ones(d, dtype=torch.bool, device=x.device)
    off = ~torch.eye(d, dtype=torch.bool, device=x.device)
    xp = x_plain
    order, worst, tied, ratio = [], 0.0, 0, 0.0
    for step in range(d):
        x_std, c, _, _ = ordering.step_standardize(x, kernel)
        cm = kernel.col_moments(x_std)
        k1, k2 = kernel.moment_rows(x_std, c)
        if xp is None:
            cmp = cm
            p1, p2 = plain.moment_rows(x_std, c)
        else:
            xp_std, cp, mu_p, var_p = ordering.step_standardize(xp, plain)
            cmp = plain.col_moments(xp_std)
            p1, p2 = plain.moment_rows(xp_std, cp)
        err = max(float((k1 - p1)[off].abs().max()),
                  float((k2 - p2)[off].abs().max()))
        worst = max(worst, err)
        s_kernel = ordering.step_scores(*cm, k1, k2, active)
        s_plain = ordering.step_scores(*cmp, p1, p2, active)
        if xp is None:
            tol = score_tolerance(*cmp, p1, p2, active, atol)
        else:
            col_err = max(float((a - b)[active].abs().max())
                          for a, b in zip(cm, cmp))
            worst = max(worst, col_err)
            tol = score_tolerance(*cmp, p1, p2, active, max(atol, err),
                                  max(atol, col_err))
        root, best = int(s_kernel.argmax()), int(s_plain.argmax())
        if root != best:
            tied += 1
            gap = float(s_plain[best] - s_plain[root])
            ratio = max(ratio, gap / float(tol[root] + tol[best]))
            if gap > float(tol[root] + tol[best]):
                fail(f"step {step}: plain scores rank root {best} above the "
                     f"kernel's {root} by {gap:.3e}, beyond the tolerance")
        x, active_next, r = ordering.ordering_step(x, active, kernel)
        if int(r) != root:
            fail(f"step {step}: replay picked {int(r)}, expected {root}")
        if xp is not None:
            xp, _ = ordering.residualize(xp, active, r, mu_p, var_p, plain)
        active = active_next
        order.append(root)
    return np.array(order), worst, tied, ratio


def parting_tie(x, order_a, order_b, reducer, atol):
    """:func:`benchmarks.torch_equivalence.parting_tie` (the first position
    where ``order_b`` parts from ``order_a``, and the two roots' score gap
    there over the tolerance that moments moved by ``atol`` allow); fails
    when the gap exceeds the tolerance."""
    from benchmarks.torch_equivalence import parting_tie as part

    p, ratio = part(x, order_a, order_b, reducer, atol)
    if ratio > 1.0:
        fail(f"orders part at position {p} ({int(order_a[p])} against "
             f"{int(order_b[p])}) by {ratio:.3f} of the score tolerance")
    return p, ratio


def order_consistent(order, b_true) -> bool:
    """No true edge may point from a later to an earlier variable."""
    d = len(order)
    pos = np.empty(d, int)
    pos[np.asarray(order)] = np.arange(d)
    src, dst = np.nonzero(b_true)  # b[i, j] != 0: j -> i
    return bool(np.all(pos[dst] < pos[src]))


def paper_experiments(dev, cuda_ms, sms, clock_mhz):
    """Phase 12, the paper's experiments (section 3.1, Fig. 2 and 3,
    Table 1, section 4.2) through the port's benchmarks, all on ``dev``.
    Their B1 launches are counted over the phase, less the gene-shape
    timing and comparison launches. Returns (those launches, B1 ms at the
    gene fit's first step, its bound (ms, by operations, by bytes), that
    shape as "m x d", B1's error there against float64)."""
    import torch
    from torch.overrides import TorchFunctionMode

    from benchmarks import (torch_equivalence, torch_gene, torch_speedup,
                            torch_stocks)
    from repro_torch.baselines import golem, ica_lingam, notears
    from repro_torch.core import ordering
    from repro_torch.data.simulate import simulate_lingam
    from repro_torch.kernels import ops, pairwise_stats

    t_exp = time.perf_counter()
    exp_s = {}
    pairwise_stats.launches = 0

    # (a) the speed-up: the sequential pair loop on the host against the
    # kernel ordering on the card, the quick grid and SPEEDUP_WIDE.
    t0 = time.perf_counter()
    cpu = torch_speedup.host_cpu()
    print(f"host CPU: {cpu['vendor']} {cpu['model']} (family "
          f"{cpu['family']}, model {cpu['model_number']}), "
          f"{cpu['threads']} threads")
    for m_s, d_s in torch_speedup.QUICK_GRID + [SPEEDUP_WIDE]:
        try:
            row = torch_speedup.shape_row(m_s, d_s, dev, reps=3)
        except RuntimeError as err:  # orders part where no tie is
            fail(str(err))
        if row["b1_launches_per_ordering"] != d_s:
            fail(f"({m_s}, {d_s}): {row['b1_launches_per_ordering']} B1 "
                 f"launches per ordering, expected {d_s}")
        print(f"speed-up ({m_s}, {d_s}): sequential {row['sequential_s']:.3f}"
              f" s (host), kernel ordering {row['kernel_ordering_s']:.4f} s, "
              f"blocked {row['blocked_ordering_s']:.4f} s, fit "
              f"{row['fit_s']:.4f} s (medians of 3); speed-up "
              f"{row['speedup']:.1f}x; ordering share of the sequential fit "
              f"{row['ordering_share']:.3f}; orders equal "
              f"{row['orders_equal_sequential']} (parting at "
              f"{row['parting_sequential']}, gap "
              f"{row['parting_gap_ratio_sequential']:.3f} of the tie "
              f"tolerance)")
    exp_s["speedup"] = time.perf_counter() - t0

    # (b) equivalence (paper Fig. 3): 10 simulations of (3000, 8).
    t0 = time.perf_counter()
    eq = torch_equivalence.run(quick=True, device=dev)
    exp_s["equivalence"] = time.perf_counter() - t0
    print(f"equivalence: {eq['n_sims']} sims of ({eq['m']}, {eq['d']}): "
          f"order match {eq['order_match_rate']:.2f} (partings within "
          f"{eq['parting_gap_ratio_max']:.3f} of the tie tolerance), F1 "
          f"{eq['f1_mean']:.3f} +- {eq['f1_std']:.3f}, SHD "
          f"{eq['shd_mean']:.2f}")
    if eq["f1_mean"] < 0.9 or eq["parting_gap_ratio_max"] > 1.0:
        fail("the port's DirectLiNGAM does not reproduce paper Fig. 3")

    # (c) the baselines on the card at (2000, 10), seed 0. A torch
    # function mode records the devices of the tensors that each one's
    # working operations receive.
    class DeviceLog(TorchFunctionMode):
        def __init__(self, watched):
            super().__init__()
            self.watched, self.seen = watched, {}

        def __torch_function__(self, func, types, args=(), kwargs=None):
            name = getattr(func, "__name__", "")
            if name in self.watched:
                self.seen.setdefault(name, set()).update(
                    a.device.type for a in args if torch.is_tensor(a))
            return func(*args, **(kwargs or {}))

    gt_c = simulate_lingam(m=2000, d=10, seed=0)
    baselines = {}
    for name, watched, fit in (
        ("notears", {"linalg_matrix_exp", "matmul"},
         lambda: notears.notears_fit(
            gt_c.data, lam=0.01, inner_steps=300, max_outer=8)),
        ("golem", {"linalg_matrix_exp", "linalg_slogdet", "matmul"},
         lambda: golem.golem_fit(gt_c.data, n_steps=1000)),
        ("ica_lingam", {"linalg_eigh", "tanh", "matmul",
                        "linalg_solve_ex"},
         lambda: ica_lingam.ICALiNGAM(n_steps=200, prune_threshold=0.1)
         .fit(gt_c.data).adjacency_),
    ):
        log = DeviceLog(watched)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with log:
            b_c = fit()
        sec = time.perf_counter() - t0
        f1, rec, shd = torch_equivalence.f1_rec_shd(b_c, gt_c.adjacency)
        baselines[name] = {"f1": float(f1), "recall": float(rec),
                           "shd": int(shd), "s": sec}
        print(f"{name} (2000, 10) on the card: {sec:.2f} s, F1 {f1:.3f}, "
              f"recall {rec:.3f}, SHD {shd}; devices of its "
              f"{sorted(watched)} inputs: {log.seen}")
        if set(log.seen) != watched or any(v != {dev.type}
                                          for v in log.seen.values()):
            fail(f"{name}'s working tensors were not all on the card")
    if not baselines["ica_lingam"]["f1"] > 0.7:
        fail("ICA-LiNGAM recovers the DAG at F1 <= 0.7")
    exp_s["baselines"] = sum(b["s"] for b in baselines.values())

    # (d) the gene study at the paper's width (Table 1): m = 50,000,
    # d = 961, 192 interventions. The simulation is a host loop.
    t0 = time.perf_counter()
    gene_data = torch_gene.gene_data(quick=False)
    exp_s["gene_simulate"] = time.perf_counter() - t0
    print(f"simulate_gene_perturb (50,000, 961) on the host: "
          f"{exp_s['gene_simulate']:.1f} s; training rows "
          f"{gene_data.x_train.shape[0]}")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gene = torch_gene.run(quick=False, device=dev, data=gene_data)
    exp_s["gene"] = time.perf_counter() - t0
    experiments_launches = pairwise_stats.launches
    gene_peak = torch.cuda.max_memory_allocated()
    dl_g, nt_g = gene["directlingam"], gene["notears"]
    print(f"gene study (m={gene['m']}, d={gene['d']}, {gene['n_held_out']} "
          f"held-out interventions): DirectLiNGAM fit {dl_g['fit_s']:.2f} s "
          f"({dl_g['b1_launches']} B1 launches), I-NLL {dl_g['inll']:.4f}, "
          f"I-MAE {dl_g['imae']:.4f}; NOTEARS fit {nt_g['fit_s']:.2f} s, "
          f"I-NLL {nt_g['inll']:.4f}, I-MAE {nt_g['imae']:.4f}; SVGD "
          f"{dl_g['svgd_s']:.2f} / {nt_g['svgd_s']:.2f} s; peak device "
          f"memory {gene_peak / 2**30:.2f} GiB")
    gene_vals = [v for r in (dl_g, nt_g) for v in
                 (r["inll"], r["imae"], r["noise_scale"])]
    if not np.all(np.isfinite(gene_vals)) or dl_g["b1_launches"] != gene["d"]:
        fail("the gene study is not finite, or its fit missed B1")
    # B1 at the fit's first step: timed, and a 64-row tile of pairs held
    # against the float64 plain version.
    xs_g, c_g, _, _ = ordering.step_standardize(
        torch.from_numpy(gene_data.x_train).to(dev), ordering.LocalReducer())
    m_g, d_g = xs_g.shape
    g1, g2 = ops.pairwise_moments(xs_g, c_g)
    q1, q2 = pairwise_stats.pairwise_moment_sums_plain(
        xs_g.double(), c_g.double(), row0=0, rows=64)
    gene_err = max(offdiag_err(g1[:64], q1 / m_g),
                   offdiag_err(g2[:64], q2 / m_g))
    gene_ms = cuda_ms(lambda: ops.pairwise_moments(xs_g, c_g), 5)
    gene_bound = moment_bound_ms(d_g, d_g, m_g,
                                 4 * (m_g * d_g + 3 * d_g * d_g), sms,
                                 clock_mhz)
    print(f"B1 at the gene fit's first step ({m_g}, {d_g}): {gene_ms:.3f} ms "
          f"(median of 5, CUDA events), bound {gene_bound[0]:.3f} ms "
          f"(special-function ops {gene_bound[1]:.3f}, bytes "
          f"{gene_bound[2]:.3f}); rows 0-63 against float64: max "
          f"off-diagonal err {gene_err:.3e} (tolerance {ATOL_F64_FULL})")
    if not gene_err <= ATOL_F64_FULL:
        fail(f"B1 disagrees with its float64 plain version at the gene "
             f"shape: {gene_err}")
    del xs_g, c_g, g1, g2, q1, q2, gene_data
    pairwise_stats.launches = experiments_launches  # timing does not count

    # (e) the stock panel (paper Fig. 4 / Table 2) at d = 487.
    t0 = time.perf_counter()
    stocks = torch_stocks.run(quick=False, device=dev)
    exp_s["stocks"] = time.perf_counter() - t0
    print(f"stocks (m={stocks['m']}, d={stocks['d']}): VarLiNGAM fit "
          f"{stocks['fit_s']:.3f} s, b0 precision "
          f"{stocks['b0_precision']:.3f}, recall {stocks['b0_recall']:.3f}")
    if not (0.0 < stocks["b0_precision"] <= 1.0
            and 0.0 < stocks["b0_recall"] <= 1.0):
        fail("the stock panel's graph is empty")
    experiments_launches = pairwise_stats.launches
    exp_total = time.perf_counter() - t_exp
    print("experiments phase: " + ", ".join(
        f"{k} {v:.1f} s" for k, v in exp_s.items())
        + f"; {exp_total:.1f} s in all, {experiments_launches} B1 launches")
    return (experiments_launches, gene_ms, gene_bound, f"{m_g}x{d_g}",
            gene_err)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on the card",
              file=sys.stderr)
        return 1

    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.configs.lingam_workloads import (STREAM_WORKLOADS,
                                                      WORKLOADS)
    from repro_torch.core import (DirectLiNGAM, VarLiNGAM, api, batched,
                                  bootstrap, ordering)
    from repro_torch.data.simulate import (simulate_lingam,
                                           simulate_var_breaks,
                                           simulate_var_stocks)
    from repro_torch.infer import effects, intervene, rca
    from repro_torch.infer import query as query_lib
    from repro_torch.kernels import build, fused_stats, ops, pairwise_stats
    from repro_torch.kernels.tune import autotune
    from repro_torch.kernels.tune import cache as tune_cache
    from repro_torch.kernels.tune import registry as tune_registry
    from repro_torch.serve import engine as serve_engine
    from repro_torch.stream import (MonitorConfig, StreamConfig,
                                    StreamSession, stats, window)

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
    sources = ("pairwise_moments", "fused_moments")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as pool:  # one nvcc per source
        list(pool.map(build.load, sources))
    print(f"build: {len(sources)} sources in parallel in "
          f"{time.perf_counter() - t0:.2f} s")
    ptxas = {}
    for name in sources:
        info = build.build_info[name]
        print(f"build: {name}.cu in {info['seconds']:.2f} s")
        ptxas.update(ptxas_report(info["log"]))
    for entry, rep in ptxas.items():
        print(f"  ptxas: {entry}: {rep}")
    # A cached library keeps its nvcc log beside it, so the report is
    # whole on every run.
    if len(ptxas) != 7 or any(len(r) != 3 for r in ptxas.values()):
        fail(f"ptxas report incomplete: {ptxas}")

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
    x_std, c, mu_full, var_full = ordering.step_standardize(
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

    # Width invariance: the leading columns, standardized once and sliced,
    # give bit for bit the full launch's pairs, whatever pair block the
    # launcher picks at each width.
    def width_invariant(xs, cs, full, width):
        w1, w2 = ops.pairwise_moments(xs[:, :width].contiguous(),
                                      cs[:width, :width].contiguous())
        torch.cuda.synchronize()
        tile = pairwise_stats.tile_for(width, width, pairwise_stats.slab_plan(
            xs.shape[0]).n_z, sms)
        same = (torch.equal(w1, full[0][:width, :width])
                and torch.equal(w2, full[1][:width, :width]))
        print(f"B1 width invariance (m={xs.shape[0]}): the leading {width} "
              f"of {xs.shape[1]} columns (pair block {tile} x {tile}) equal "
              f"the full launch's pairs bit for bit: {same}")
        if not same:
            fail(f"B1 is not width-invariant at {width} of {xs.shape[1]}")

    for width in (75, 56):
        width_invariant(x_std, c, (a1, a2), width)
    xv_std = ops.standardize(torch.from_numpy(
        rng.laplace(size=(3999, 487)).astype(np.float32)).to(dev))
    cv = ops.correlation(xv_std).contiguous()
    v1, v2 = ops.pairwise_moments(xv_std, cv)
    p1, p2 = pairwise_stats.pairwise_moment_sums_plain(xv_std, cv)
    inv_mv = float(np.float32(1.0 / 3999))
    var_err = max(offdiag_err(v1, p1 * inv_mv), offdiag_err(v2, p2 * inv_mv))
    width_invariant(xv_std, cv, (v1, v2), 243)
    var_b1_ms = cuda_ms(lambda: ops.pairwise_moments(xv_std, cv), 20)
    var_b1_plain_ms = cuda_ms(
        lambda: pairwise_stats.pairwise_moment_sums_plain(xv_std, cv), 3)
    var_b1_bound = moment_bound_ms(487, 487, 3999,
                                   4 * (3999 * 487 + 3 * 487 * 487), sms,
                                   clock_mhz)
    print(f"B1 at the VarLiNGAM shape (m=3999, d=487): {var_b1_ms:.4f} ms per "
          f"launch (median of 20, CUDA events); plain version "
          f"{var_b1_plain_ms:.2f} ms; bound {var_b1_bound[0]:.4f} ms "
          f"(special-function ops {var_b1_bound[1]:.4f} ms, bytes "
          f"{var_b1_bound[2]:.4f} ms); vs plain: max off-diagonal err "
          f"{var_err:.3e} (tolerance {ATOL_F32})")
    if var_err > ATOL_F32:
        fail(f"B1 disagrees at (3999, 487): {var_err}")
    del xv_std, cv, v1, v2, p1, p2

    # 3. kernel B2 (row-tile sums, scale 1) against its plain version:
    # the reference's padding-edge cells, each at row offset 0 and > 0.
    def tile_offsets(tile, d_e):
        return [(row0, min(tile, d_e - row0))
                for row0 in (0, max(1, d_e - tile))]

    worst_rows = 0.0
    for tile, d_e, m_e in EDGE_CELLS:
        x = torch.from_numpy(rng.laplace(size=(m_e, d_e)).astype(np.float32))
        xs = ops.standardize(x.to(dev))
        c_e = ops.correlation(xs).contiguous()
        for row0, rows in tile_offsets(tile, d_e):
            k1, k2 = pairwise_stats.pairwise_moment_sums_rows(xs, c_e, row0,
                                                              rows)
            r1, r2 = pairwise_stats.pairwise_moment_sums_rows(xs, c_e, row0,
                                                              rows)
            p1, p2 = pairwise_stats.pairwise_moment_sums_plain(
                xs, c_e, row0=row0, rows=rows)
            torch.cuda.synchronize()
            same = torch.equal(k1, r1) and torch.equal(k2, r2)
            ok = bool(torch.isfinite(k1).all() and torch.isfinite(k2).all())
            err = max(offdiag_err(k1, p1, row0),
                      offdiag_err(k2, p2, row0)) / m_e
            print(f"B2 vs plain (tile={rows}, d={d_e}, m={m_e}, "
                  f"row0={row0}): max off-diagonal err {err:.3e} per sample "
                  f"(tolerance {ATOL_ROWS}), two launches bit-identical "
                  f"{same}, finite {ok}")
            if not (same and ok) or err > ATOL_ROWS:
                fail(f"B2 disagrees at ({rows}, {d_e}, {m_e}, {row0})")
            worst_rows = max(worst_rows, err)
    # The rolling stream's shape: a 2048-row window of 487 variables in
    # 256-row slabs, one slab-structured B2 launch per ordering step.
    sw = STREAM_WORKLOADS["varlingam-stream-487"]
    m_w, d_w = sw.chunk * sw.window_chunks, sw.d
    xw = ops.standardize(torch.from_numpy(
        rng.laplace(size=(m_w, d_w)).astype(np.float32)).to(dev))
    cw = ops.correlation(xw).contiguous()
    slab = xw[:sw.chunk]
    s1, s2 = pairwise_stats.pairwise_moment_sums_rows(slab, cw, 0, d_w)
    t1, t2 = pairwise_stats.pairwise_moment_sums_rows(slab, cw, 0, d_w)
    q1, q2 = pairwise_stats.pairwise_moment_sums_plain(slab.double(),
                                                       cw.double())
    torch.cuda.synchronize()
    same = torch.equal(s1, t1) and torch.equal(s2, t2)
    rows_err = max(offdiag_err(s1, q1), offdiag_err(s2, q2))
    before = pairwise_stats.rows_launches
    w1, w2 = ops.pairwise_moment_sums_chunked(xw, cw, chunk=sw.chunk)
    n_step = pairwise_stats.rows_launches - before
    q1, q2 = pairwise_stats.pairwise_moment_sums_plain(xw.double(),
                                                       cw.double())
    torch.cuda.synchronize()
    win_err = max(offdiag_err(w1, q1), offdiag_err(w2, q2))
    n_slabs = -(-m_w // sw.chunk)
    print(f"B2 at the stream shape: one slab (m={sw.chunk}, d={d_w}) vs "
          f"float64 plain: max off-diagonal err {rows_err:.3e} "
          f"({rows_err / sw.chunk:.3e} per sample), two launches "
          f"bit-identical {same}; the {m_w}-row window, {n_slabs} slabs in "
          f"{n_step} launch, vs float64 plain: {win_err:.3e} "
          f"({win_err / m_w:.3e} per sample; tolerance {ATOL_ROWS} per "
          f"sample)")
    if (not same or rows_err > ATOL_ROWS * sw.chunk
            or win_err > ATOL_ROWS * m_w):
        fail("B2 disagrees at the stream shape")
    if n_step != 1:
        fail(f"expected 1 B2 launch for the {n_slabs} slabs, got {n_step}")

    def per_slab(x, step):
        """The per-slab launches, their sums added in slab order."""
        t = None
        for k0 in range(0, x.shape[0], step):
            u = pairwise_stats.pairwise_moment_sums_rows(x[k0:k0 + step], cw,
                                                         0, d_w)
            t = u if t is None else (t[0] + u[0], t[1] + u[1])
        return t

    # The slab-structured launch against the per-slab launches, at the
    # window and at a ragged sample count (7 full slabs and 208 rows).
    for m_s in (m_w, 2000):
        got = pairwise_stats.pairwise_moment_sums_slabs(xw[:m_s], cw,
                                                        sw.chunk)
        want = per_slab(xw[:m_s], sw.chunk)
        torch.cuda.synchronize()
        merged = torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        print(f"B2 slab merge (m={m_s}, slabs of {sw.chunk}): one launch "
              f"equals the per-slab launches added in order bit for bit: "
              f"{merged}")
        if not merged:
            fail(f"the slab-structured B2 launch differs at m={m_s}")
    rows_ms = cuda_ms(
        lambda: pairwise_stats.pairwise_moment_sums_rows(slab, cw, 0, d_w), 50)
    step_ms = cuda_ms(
        lambda: ops.pairwise_moment_sums_chunked(xw, cw, chunk=sw.chunk), 50)
    per_slab_ms = cuda_ms(lambda: per_slab(xw, sw.chunk), 20)

    def per_slab_plain():
        for k0 in range(0, m_w, sw.chunk):
            pairwise_stats.pairwise_moment_sums_plain(xw[k0:k0 + sw.chunk], cw)

    step_plain_ms = cuda_ms(per_slab_plain, 3)
    rows_bound = moment_bound_ms(
        d_w, d_w, sw.chunk, 4 * (sw.chunk * d_w + 3 * d_w * d_w), sms,
        clock_mhz)
    step_bound = moment_bound_ms(
        d_w, d_w, m_w, 4 * (m_w * d_w + 3 * d_w * d_w), sms, clock_mhz)
    print(f"B2 one ordering step at (m={m_w}, d={d_w}) in {n_slabs} slabs: "
          f"{step_ms:.4f} ms per launch (median of 50, CUDA events); the "
          f"same sums as {n_slabs} per-slab launches {per_slab_ms:.4f} ms; "
          f"plain version {step_plain_ms:.2f} ms; bound {step_bound[0]:.4f} "
          f"ms (special-function ops {step_bound[1]:.4f} ms, bytes "
          f"{step_bound[2]:.4f} ms)")
    print(f"B2 one slab (m={sw.chunk}, d={d_w}, rows={d_w}): {rows_ms:.4f} ms "
          f"per launch (median of 50, CUDA events); bound "
          f"{rows_bound[0]:.4f} ms")
    del xw, cw, slab, s1, s2, t1, t2, q1, q2, w1, w2

    # 4. kernel B3 (fused standardize + sums from raw X) against its plain
    # version, float32 and bfloat16, at the edge cells.
    worst_fused = 0.0
    for tile, d_e, m_e in EDGE_CELLS:
        x = torch.from_numpy(
            rng.laplace(size=(m_e, d_e)).astype(np.float32)).to(dev)
        mu_e = x.mean(dim=0)
        rstd_e = torch.rsqrt(((x - mu_e) ** 2).mean(dim=0))
        c_e = ops.correlation((x - mu_e) * rstd_e).contiguous()
        for dtype in (torch.float32, torch.bfloat16):
            xr = x.to(dtype)
            for row0, rows in tile_offsets(tile, d_e):
                k1, k2 = fused_stats.fused_moment_sums(xr, mu_e, rstd_e, c_e,
                                                       row0, rows)
                r1, r2 = fused_stats.fused_moment_sums(xr, mu_e, rstd_e, c_e,
                                                       row0, rows)
                p1, p2 = fused_stats.fused_moment_sums_plain(
                    xr, mu_e, rstd_e, c_e, row0=row0, rows=rows)
                torch.cuda.synchronize()
                same = torch.equal(k1, r1) and torch.equal(k2, r2)
                ok = bool(torch.isfinite(k1).all()
                          and torch.isfinite(k2).all())
                err = max(offdiag_err(k1, p1, row0),
                          offdiag_err(k2, p2, row0)) / m_e
                print(f"B3 vs plain ({str(dtype)[6:]}, tile={rows}, "
                      f"d={d_e}, m={m_e}, row0={row0}): max off-diagonal "
                      f"err {err:.3e} per sample (tolerance {ATOL_FUSED}), "
                      f"two launches bit-identical {same}, finite {ok}")
                if not (same and ok) or err > ATOL_FUSED:
                    fail(f"B3 disagrees at ({dtype}, {rows}, {d_e}, {m_e})")
                worst_fused = max(worst_fused, err)
    # Full size: the raw lingam-1m-100 data with the step's own mu and
    # 1/std, so that the fused standardization gives B1's input values.
    rstd_full = torch.rsqrt(var_full)
    x_bf16 = x_full.to(torch.bfloat16)
    fused = {}
    for label, xr in (("float32", x_full), ("bfloat16", x_bf16)):
        f1, f2 = fused_stats.fused_moment_sums(xr, mu_full, rstd_full, c, 0, d)
        g1, g2 = fused_stats.fused_moment_sums(xr, mu_full, rstd_full, c, 0, d)
        torch.cuda.synchronize()
        same = torch.equal(f1, g1) and torch.equal(f2, g2)
        t0 = time.perf_counter()
        q1, q2 = fused_stats.fused_moment_sums_plain(
            xr.double(), mu_full.double(), rstd_full.double(), c.double())
        torch.cuda.synchronize()
        plain64_s = time.perf_counter() - t0
        err = max(offdiag_err(f1, q1), offdiag_err(f2, q2))
        ms = cuda_ms(
            lambda: fused_stats.fused_moment_sums(xr, mu_full, rstd_full, c,
                                                  0, d), 10)
        bound = moment_bound_ms(
            d, d, m, xr.element_size() * m * d + 4 * (2 * d + 3 * d * d),
            sms, clock_mhz)
        print(f"B3 at (m={m}, d={d}, tile={d}), {label} X: {ms:.3f} ms per "
              f"launch (median of 10, CUDA events); bound {bound[0]:.3f} ms "
              f"(special-function ops {bound[1]:.3f} ms, bytes "
              f"{bound[2]:.3f} ms); vs float64 plain: max off-diagonal err "
              f"{err:.3e} ({err / m:.3e} per sample, tolerance "
              f"{ATOL_F64_FULL}), float64 plain {plain64_s:.1f} s; two "
              f"launches bit-identical {same}")
        if not same or err > ATOL_F64_FULL * m or not (
                torch.isfinite(f1).all() and torch.isfinite(f2).all()):
            fail(f"B3 ({label}) disagrees at full size")
        fused[label] = {"s": (f1, f2), "err": err, "ms": ms, "bound": bound}
        del q1, q2, g1, g2
    inv_m = float(np.float32(1.0 / m))
    f1, f2 = fused["float32"]["s"]
    vs_b1 = max(offdiag_err(f1 * inv_m, a1), offdiag_err(f2 * inv_m, a2))
    print(f"B3 (float32 X) x 1/m vs B1 on the standardized X: max "
          f"off-diagonal err {vs_b1:.3e} (tolerance {ATOL_F32})")
    if vs_b1 > ATOL_F32:
        fail(f"B3 and B1 disagree on the same values: {vs_b1}")
    # Exactly the same values (mean 0, 1/std 1 leave x_std as it is): one
    # integrand header, one summation order, so B3's sums are B2's bits.
    zero, one = torch.zeros(d, device=dev), torch.ones(d, device=dev)
    z1, z2 = fused_stats.fused_moment_sums(x_std, zero, one, c, 0, d)
    r1, r2 = pairwise_stats.pairwise_moment_sums_rows(x_std, c, 0, d)
    torch.cuda.synchronize()
    b3_bits = torch.equal(z1, r1) and torch.equal(z2, r2)
    print(f"B3 on the standardized X (mean 0, 1/std 1) equals B2's sums "
          f"bit for bit: {b3_bits}")
    if not b3_bits:
        fail("B3 and B2 sums differ on the same standardized values")
    del z1, z2, r1, r2
    fused_plain_ms = cuda_ms(
        lambda: fused_stats.fused_moment_sums_plain(x_full, mu_full,
                                                    rstd_full, c), 2)
    print(f"B3 plain version at (m={m}, d={d}), float32: "
          f"{fused_plain_ms:.1f} ms")
    # B3's path: its entry point, once in each input type.
    fused_stats.launches = 0
    e32 = ops.fused_moment_rows(x_full, mu_full, rstd_full, c, 0, d)
    e16 = ops.fused_moment_rows(x_bf16, mu_full, rstd_full, c, 0, d)
    torch.cuda.synchronize()
    fused_launches = fused_stats.launches
    print(f"B3 entry point ops.fused_moment_rows (float32, bfloat16): "
          f"{fused_launches} launches")
    if fused_launches != 2:
        fail(f"expected 2 B3 launches, got {fused_launches}")
    if not (torch.equal(e32[0], f1)
            and torch.equal(e16[0], fused["bfloat16"]["s"][0])):
        fail("ops.fused_moment_rows differs from the kernel's own result")
    del x_bf16, e32, e16, f1, f2, fused["float32"]["s"], fused["bfloat16"]["s"]
    del x_std, c, a1, a2, b1, b2

    # 5. mid-size fit: kernel against the plain blocked backend. The
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

    # 6. full-size fit: the main path
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
    del x_full

    def forward_share(order, b_true):
        """Share of the true edges (b[i, j] != 0: j -> i) that the order
        puts forward, parent before child."""
        pos = np.empty(len(order), int)
        pos[np.asarray(order)] = np.arange(len(order))
        src, dst = np.nonzero(b_true)
        return float(np.mean(pos[dst] < pos[src])) if len(src) else 1.0

    # 7. the VarLiNGAM facade at varlingam-stocks-487 (paper section 4.2)
    wv = WORKLOADS["varlingam-stocks-487"]
    t0 = time.perf_counter()
    xv, b0_v, _ = simulate_var_stocks(m=wv.m, d=wv.d, seed=0)
    print(f"simulate_var_stocks(m={wv.m}, d={wv.d}, seed=0) on the host: "
          f"{time.perf_counter() - t0:.1f} s")
    pairwise_stats.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    var_model = VarLiNGAM().fit(xv)
    var_fit_s = time.perf_counter() - t0
    var_launches = pairwise_stats.launches
    thetas_ok = all(np.isfinite(t).all()
                    for t in var_model.adjacency_matrices_)
    print(f"VarLiNGAM fit {wv.name} (m={wv.m}, d={wv.d}, lags 1, compaction "
          f"'none'): {var_fit_s:.3f} s, B1 launches {var_launches}, thetas "
          f"finite {thetas_ok}, true edges forward "
          f"{forward_share(var_model.causal_order_, b0_v):.3f}")
    if var_launches != wv.d or not thetas_ok:
        fail("the VarLiNGAM facade fit is wrong")
    resid = torch.from_numpy(var_model.residuals_).to(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ordering.causal_order(resid).cpu()
    print(f"VarLiNGAM residual ordering alone: "
          f"{time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    replay, var_err, tied, ratio = walk_against_plain(
        resid, ordering.LocalReducer(),
        ordering.LocalReducer(backend="blocked"), ATOL_F32)
    print(f"VarLiNGAM replay against 'blocked' ({time.perf_counter() - t0:.1f}"
          f" s): moments max off-diagonal err {var_err:.3e}, {tied} of "
          f"{wv.d} steps broke a tie differently, largest score gap "
          f"{ratio:.3f} of its tolerance")
    if var_err > ATOL_F32 or not np.array_equal(replay,
                                                var_model.causal_order_):
        fail("the VarLiNGAM kernel fit disagrees with 'blocked'")
    del resid, var_model

    # 8. the rolling stream: 12 chunks through a StreamSession, a refit
    # whenever one is due. The counts are read right after this loop.
    sw = STREAM_WORKLOADS["varlingam-stream-487"]
    n_chunks = sw.window_chunks + 4
    t0 = time.perf_counter()
    series, b0_s, _ = simulate_var_stocks(m=sw.chunk * n_chunks + 8, d=sw.d,
                                          seed=0)
    print(f"simulate_var_stocks(m={sw.chunk * n_chunks + 8}, d={sw.d}, "
          f"seed=0) on the host: {time.perf_counter() - t0:.1f} s")
    session = StreamSession(sw.name, StreamConfig(
        d=sw.d, chunk=sw.chunk, window_chunks=sw.window_chunks, lags=sw.lags,
        refit_every=sw.refit_every))
    cfg = session.rolling.config
    n_slabs = -(-sw.chunk * sw.window_chunks // cfg.moment_chunk)
    refits, post_s = [], []
    pairwise_stats.launches = 0
    pairwise_stats.rows_launches = 0
    torch.cuda.synchronize()
    t_stream = time.perf_counter()
    for k in range(n_chunks):
        t0 = time.perf_counter()
        due = session.post(series[k * sw.chunk:(k + 1) * sw.chunk])
        torch.cuda.synchronize()
        post_s.append(time.perf_counter() - t0)
        if due:
            before = pairwise_stats.rows_launches
            t0 = time.perf_counter()
            delta = session.refit_now()
            torch.cuda.synchronize()
            refit_s = time.perf_counter() - t0
            n_launch = pairwise_stats.rows_launches - before
            # The refit's inputs again (no kernel runs in them), kept for
            # the checks below and timed for the refit's split.
            t0 = time.perf_counter()
            plan = session.rolling.prepare_refit()
            torch.cuda.synchronize()
            refits.append({
                "delta": delta, "fit": session.last_fit, "seconds": refit_s,
                "launches": n_launch, "plan": plan,
                "plan_s": time.perf_counter() - t0,
                "blocks": list(session.rolling.ring),
                "lead": session.rolling._lead_tail,
            })
    stream_s = time.perf_counter() - t_stream
    stream_launches = pairwise_stats.rows_launches
    stream_b1 = pairwise_stats.launches
    for j, r in enumerate(refits):
        print(f"stream refit {j}: {r['seconds']:.3f} s, B2 launches "
              f"{r['launches']} (one per ordering step, each over "
              f"{n_slabs} slabs of {cfg.moment_chunk} rows), "
              f"{r['delta'].summary()}")
    print(f"stream {sw.name}: {n_chunks} chunks, {len(refits)} refits in "
          f"{stream_s:.3f} s; B2 launches {stream_launches}, B1 launches "
          f"{stream_b1}")
    if len(refits) != n_chunks - sw.window_chunks + 1:
        fail(f"expected {n_chunks - sw.window_chunks + 1} refits, got "
             f"{len(refits)}")
    if stream_b1 or any(r["launches"] != sw.d for r in refits):
        fail(f"expected {sw.d} B2 launches (one per ordering step) and no "
             f"B1 launch per refit")
    # The last window refit again: three times untraced for its wall time,
    # then once traced for B2's kernel time and the device's busy time.
    # The tracer roughly doubles a refit's wall time, so the idle share is
    # 1 - busy / the untraced median; the traced reading is printed too. A
    # refit leaves the window's state as it is.
    refit_walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        session.rolling.refit()
        torch.cuda.synchronize()
        refit_walls.append(time.perf_counter() - t0)
    refit_wall = float(np.median(refit_walls))
    prof_wall, prof_busy, prof_kernels = device_busy(session.rolling.refit)
    if prof_busy is None:
        print("stream refit traced: torch.profiler shows no device time; "
              "B2 timed with CUDA events around each launch instead, idle "
              "share not measured")
        spans = []
        real_slabs = pairwise_stats.pairwise_moment_sums_slabs

        def timed_slabs(*args, **kw):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = real_slabs(*args, **kw)
            e1.record()
            spans.append((e0, e1))
            return out

        pairwise_stats.pairwise_moment_sums_slabs = timed_slabs
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        session.rolling.refit()
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
        pairwise_stats.pairwise_moment_sums_slabs = real_slabs
        refit_b2_s = sum(a.elapsed_time(b) for a, b in spans) * 1e-3
        refit_idle = None
    else:
        refit_b2_s = sum(t for name, t in prof_kernels.items()
                         if "pair_partials" in name or "reduce_slabs" in name)
        refit_idle = 1.0 - prof_busy / refit_wall
        top = sorted(prof_kernels.items(), key=lambda kv: -kv[1])[:6]
        print("stream refit traced, device time by kernel: " + "; ".join(
            f"{name[:60]} {t * 1e3:.2f} ms" for name, t in top))
        walls = ", ".join(f"{w:.3f}" for w in refit_walls)
        print(f"stream refit: device busy {prof_busy * 1e3:.2f} ms (all "
              f"device activity, traced); idle share {refit_idle:.1%} of "
              f"the untraced median {refit_wall:.3f} s ({walls} s), "
              f"{1.0 - prof_busy / prof_wall:.1%} of the traced "
              f"{prof_wall:.3f} s")
    print(f"stream refit: B2 kernel time {refit_b2_s * 1e3:.2f} ms ({sw.d} "
          f"launches), {refit_b2_s / refit_wall:.1%} of the untraced median "
          f"refit {refit_wall:.3f} s")
    # Each refit against the from-scratch fit of the same window: equal
    # orders (thetas then within ATOL_STREAM), or orders that part only
    # at ties, which the walk below shows.
    red = ordering.LocalReducer(backend=cfg.backend,
                                moment_chunk=cfg.moment_chunk)
    for j, r in enumerate(refits):
        got = r["fit"]
        direct = window.direct_window_fit(r["blocks"], r["lead"],
                                          lags=sw.lags, config=cfg)
        same = np.array_equal(got.result.order.cpu().numpy(),
                              direct.result.order.cpu().numpy())
        adj = float((got.result.adjacency - direct.result.adjacency)
                    .abs().max())
        th = max(float(np.abs(a - b).max())
                 for a, b in zip(got.thetas, direct.thetas))
        print(f"stream refit {j} vs from-scratch window fit: orders equal "
              f"{same}, adjacency max diff {adj:.3e}, thetas max diff "
              f"{th:.3e} (tolerance {ATOL_STREAM} with equal orders)")
        if same and max(adj, th) > ATOL_STREAM:
            fail(f"refit {j}: equal orders but estimates differ by "
                 f"{max(adj, th)}")
        if same and j != 1:
            continue
        # Replay the rolling order on the rolling residuals with the
        # from-scratch ones on the plain side: always for refit 1 (the
        # first after a retraction), and wherever the orders part.
        dplan = window.direct_window_plan(r["blocks"], r["lead"],
                                          lags=sw.lags)
        x_roll = api.standardize_from_stats(
            r["plan"].resid, r["plan"].resid_mean, r["plan"].resid_cov)
        x_dir = api.standardize_from_stats(dplan.resid, dplan.resid_mean,
                                           dplan.resid_cov)
        replay, diff, tied, ratio = walk_against_plain(
            x_roll, red, red, ATOL_F32, x_plain=x_dir)
        print(f"stream refit {j} replayed against the from-scratch window: "
              f"moments max diff {diff:.3e}, {tied} of {sw.d} steps broke a "
              f"tie differently, largest score gap {ratio:.3f} of its "
              f"tolerance")
        if not np.array_equal(replay, got.result.order.cpu().numpy()):
            fail(f"refit {j}: the replay does not reproduce the order")
        del x_roll, x_dir, dplan
    # The last window: its ordering walked against 'blocked', compaction
    # "none" against the refit's "staged", and the refit's time split.
    last = refits[-1]
    plan = last["plan"]
    x_roll = api.standardize_from_stats(plan.resid, plan.resid_mean,
                                        plan.resid_cov)
    t0 = time.perf_counter()
    replay, blk_err, tied, ratio = walk_against_plain(
        x_roll, red, ordering.LocalReducer(backend="blocked",
                                           moment_chunk=cfg.moment_chunk),
        ATOL_F32)
    print(f"stream refit {len(refits) - 1} replay against 'blocked' "
          f"({time.perf_counter() - t0:.1f} s): moments max off-diagonal err "
          f"{blk_err:.3e}, {tied} of {sw.d} steps broke a tie differently, "
          f"largest score gap {ratio:.3f} of its tolerance")
    last_order = last["fit"].result.order.cpu().numpy()
    if blk_err > ATOL_F32 or not np.array_equal(replay, last_order):
        fail("the stream refit's kernel ordering disagrees with 'blocked'")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ordering.compact_order_impl(x_roll, red, frac=cfg.compaction_frac,
                                min_stage=cfg.min_stage).cpu()
    order_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    api.fit_from_stats(plan.resid, plan.resid_mean, plan.resid_cov,
                       cfg).order.cpu()
    from_stats_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    masked = api.fit_from_stats(
        plan.resid, plan.resid_mean, plan.resid_cov,
        dataclasses.replace(cfg, compaction="none")).order.cpu().numpy()
    masked_s = time.perf_counter() - t0
    print(f"stream refit {len(refits) - 1}: compaction 'none' "
          f"({masked_s:.3f} s) and 'staged' give one order "
          f"{np.array_equal(masked, last_order)}")
    if not np.array_equal(masked, last_order):
        fail("compaction 'none' and 'staged' give different stream orders")
    update_s = float(np.mean(post_s[sw.window_chunks:]))
    print(f"stream refit time split (last window, each part timed alone): "
          f"state update per post (absorb + retract) {update_s:.4f} s; VAR "
          f"solve + residuals {last['plan_s']:.4f} s; ordering "
          f"{order_s:.3f} s; pruning + diagnostics "
          f"{from_stats_s - order_s:.3f} s (difference of fit_from_stats "
          f"{from_stats_s:.3f} s and the ordering); whole refit "
          f"{last['seconds']:.3f} s")
    print(f"stream: true edges forward in the last refit's order "
          f"{forward_share(last_order, b0_s):.3f} (for the record: at 2048 "
          f"samples the estimator may miss weak edges)")
    del refits, plan, x_roll, session

    # 9. the bootstrap at the stock panel's width. First the batch grid
    # axis: a batched launch gives every element the bits of the launch
    # on that element alone.
    def batch_equal(what, got, singles):
        same = all(torch.equal(got[0][k], s[0]) and torch.equal(got[1][k],
                                                                 s[1])
                   for k, s in enumerate(singles))
        print(f"{what}: one batched launch equals the per-element launches "
              f"bit for bit: {same}")
        if not same:
            fail(f"{what}: the batched launch differs")

    def standardized_batch(b, m_s, d_s):
        xs_b = torch.stack([ops.standardize(torch.from_numpy(
            rng.laplace(size=(m_s, d_s)).astype(np.float32)).to(dev))
            for _ in range(b)]).contiguous()
        return xs_b, torch.stack([ops.correlation(x) for x in xs_b]
                                 ).contiguous()

    xb, cb = standardized_batch(4, wv.m, wv.d)
    for label, xk, ck in (
            (f"B1 batch 4 x ({wv.m}, {wv.d})", xb, cb),
            (f"B1 batch 4 x ({wv.m}, 243), a staged width",
             xb[..., :243].contiguous(), cb[..., :243, :243].contiguous()),
            (f"B1 batch 4 x ({wv.m - 1}, {wv.d}), ragged m",
             xb[:, :wv.m - 1].contiguous(), cb)):
        before = pairwise_stats.launches
        got = ops.pairwise_moments(xk, ck)
        if pairwise_stats.launches != before + 1:
            fail(f"{label}: expected one launch")
        batch_equal(label, got, [ops.pairwise_moments(xk[k], ck[k])
                                 for k in range(xk.shape[0])])
    del xb, cb
    worst_batched = 0.0
    for m_t, d_t in TEST_SHAPES:
        xk, ck = standardized_batch(3, m_t, d_t)
        k1, k2 = pairwise_stats.pairwise_moments(xk, ck)
        p1, p2 = pairwise_stats.pairwise_moment_sums_plain(xk, ck)
        inv_t = float(np.float32(1.0 / m_t))
        err = max(max(offdiag_err(k1[k], p1[k] * inv_t),
                      offdiag_err(k2[k], p2[k] * inv_t)) for k in range(3))
        worst_batched = max(worst_batched, err)
        if err > ATOL_F32:
            fail(f"batched B1 disagrees with its plain version at "
                 f"(3, {m_t}, {d_t}): {err}")
    print(f"B1 batch 3 x each test shape against the batched plain version: "
          f"max off-diagonal err {worst_batched:.3e} (tolerance {ATOL_F32})")
    xk, ck = standardized_batch(2, m_w, d_w)
    before = pairwise_stats.rows_launches
    got = ops.pairwise_moment_sums_chunked(xk, ck, chunk=sw.chunk)
    if pairwise_stats.rows_launches != before + 1:
        fail("the batched slab launch is not one launch")
    batch_equal(f"B2 slab launch, batch 2 x {m_w} rows in {n_slabs} slabs of "
                f"{sw.chunk}, d={d_w}", got,
                [pairwise_stats.pairwise_moment_sums_slabs(xk[k], ck[k],
                                                           sw.chunk)
                 for k in range(2)])
    del xk, ck, got

    # The bootstrap: 32 resamples of simulate_lingam at m x d of
    # varlingam-stocks-487, staged compaction. strategy="auto" must pick
    # the batched engine: its peak model (bootstrap.vmap_peak_bytes) is
    # far below the card's free memory.
    n_boot, m_b, d_b = 32, wv.m, wv.d
    t0 = time.perf_counter()
    gt_b = simulate_lingam(m=m_b, d=d_b, seed=0)
    print(f"simulate_lingam(m={m_b}, d={d_b}, seed=0) on the host: "
          f"{time.perf_counter() - t0:.1f} s")
    cfg_b = api.FitConfig(compaction="staged")
    boot_kw = dict(n_sampling=n_boot, threshold=0.05, seed=0, config=cfg_b)
    seen = {"vmap": [], "loop": []}
    real_bootstrap_fits, real_fit_fn = batched.bootstrap_fits, api.fit_fn

    def seen_bootstrap_fits(*args, **kw):
        seen["vmap"].append(real_bootstrap_fits(*args, **kw))
        return seen["vmap"][-1]

    def seen_fit_fn(*args, **kw):
        seen["loop"].append(real_fit_fn(*args, **kw))
        return seen["loop"][-1]

    batched.bootstrap_fits, api.fit_fn = seen_bootstrap_fits, seen_fit_fn
    peak_bytes = {}

    def peak_from(base):
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated() - base

    pairwise_stats.launches = 0
    pairwise_stats.rows_launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_bytes = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    res_v = bootstrap.bootstrap_lingam(gt_b.data, strategy="auto", **boot_kw)
    vmap_s = time.perf_counter() - t0
    peak_bytes["vmap"] = peak_from(base_bytes)
    boot_launches = pairwise_stats.launches
    boot_rows = pairwise_stats.rows_launches
    peak_model = bootstrap.vmap_peak_bytes(n_boot, m_b, d_b)
    print(f"bootstrap (m={m_b}, d={d_b}, n_sampling={n_boot}, 'staged'), "
          f"strategy 'auto' took {'vmap' if seen['vmap'] else 'loop'} "
          f"(peak model {peak_model} B against the card's free memory "
          f"{torch.cuda.mem_get_info(dev)[0]} B): {vmap_s:.3f} s, "
          f"{n_boot / vmap_s:.2f} fits/s; B1 launches {boot_launches}, B2 "
          f"launches {boot_rows}")
    if len(seen["vmap"]) != 1 or seen["loop"]:
        fail("strategy 'auto' did not run the batched engine")
    if boot_launches != d_b or boot_rows:
        fail(f"expected {d_b} B1 launches (one per ordering step for all "
             f"{n_boot} resamples), got {boot_launches} (B2 {boot_rows})")
    pairwise_stats.launches = 0
    fits_v = seen["vmap"][0]  # held: the loop's peak is taken beside it
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_bytes = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    res_l = bootstrap.bootstrap_lingam(gt_b.data, strategy="loop", **boot_kw)
    loop_s = time.perf_counter() - t0
    peak_bytes["loop"] = peak_from(base_bytes)
    loop_launches = pairwise_stats.launches
    batched.bootstrap_fits, api.fit_fn = real_bootstrap_fits, real_fit_fn
    print(f"bootstrap, strategy 'loop' on the same indices: {loop_s:.3f} s, "
          f"{n_boot / loop_s:.2f} fits/s; B1 launches {loop_launches}; vmap "
          f"over loop {vmap_s / loop_s:.3f}")
    if len(seen["loop"]) != n_boot or loop_launches != n_boot * d_b:
        fail(f"expected {n_boot} loop fits of {d_b} B1 launches each")
    stack_bytes = 4 * n_boot * m_b * d_b
    print(f"bootstrap peak device memory above what was allocated before "
          f"(torch.cuda.max_memory_allocated): vmap {peak_bytes['vmap']} B "
          f"({peak_bytes['vmap'] / stack_bytes:.2f} x the {stack_bytes} B "
          f"resample stack), loop {peak_bytes['loop']} B; the 'auto' rule's "
          f"peak model {peak_model} B, {peak_model / peak_bytes['vmap']:.3f}"
          f" x the measured vmap peak (must lie in [1, {PEAK_MODEL_MARGIN}])")
    # The model must bound the measured peak (else "auto" could send a
    # batch that does not fit to the card) without wasting the card.
    if not 1.0 <= peak_model / peak_bytes["vmap"] <= PEAK_MODEL_MARGIN:
        fail("the vmap bootstrap's peak model does not fit its measured "
             "peak")
    fits_l = api.FitResult.stack(seen["loop"])
    orders_v, orders_l = fits_v.order.cpu().numpy(), fits_l.order.cpu().numpy()
    x_b = torch.from_numpy(np.ascontiguousarray(gt_b.data)).to(dev)
    idx_b = batched.resample_indices(0, n_boot, m_b, device=dev)
    parted = []
    for k in range(n_boot):
        p, ratio = parting_tie(x_b[idx_b[k]], orders_l[k], orders_v[k],
                               ordering.LocalReducer(), ATOL_F32)
        if p is not None:
            parted.append((k, p, ratio))
    prob_equal = np.array_equal(res_v.edge_prob, res_l.edge_prob)
    coef_err = max(float(np.abs(res_v.coef_mean - res_l.coef_mean).max()),
                   float(np.abs(res_v.coef_std - res_l.coef_std).max()))
    adj_equal = sum(torch.equal(fits_v.adjacency[k], fits_l.adjacency[k])
                    for k in range(n_boot))
    print(f"bootstrap vmap against loop: orders equal in "
          f"{n_boot - len(parted)} of {n_boot} resamples"
          + "".join(f"; resample {k} parts at position {p} at a tie (score "
                    f"gap {r:.3f} of its tolerance)" for k, p, r in parted)
          + f"; adjacency bit-equal in {adj_equal}; edge_prob equal "
          f"{prob_equal}; coef mean/std max diff {coef_err:.3e} (tolerance "
          f"{ATOL_ADJ}); edges with prob >= 0.7: "
          f"{len(res_v.stable_edges(0.7))}")
    if not prob_equal or coef_err > ATOL_ADJ:
        fail("the vmap and loop bootstraps disagree")
    if not (np.isfinite(res_v.coef_mean).all()
            and res_v.edge_prob.shape == (d_b, d_b)):
        fail("the bootstrap result is malformed")
    t0 = time.perf_counter()
    ci = effects.bootstrap_effects(gt_b.data, n_sampling=n_boot, seed=0,
                                   config=cfg_b)
    effects_s = time.perf_counter() - t0
    loop_effs = torch.stack([effects.total_effects(r) for r in seen["loop"]])
    want_ci = effects.effect_ci(loop_effs.cpu().numpy(), ci.level)
    ci_err = max(float(np.abs(getattr(ci, f) - getattr(want_ci, f)).max())
                 for f in ("mean", "std", "lo", "hi"))
    ci_finite = all(np.isfinite(getattr(ci, f)).all()
                    for f in ("mean", "std", "lo", "hi"))
    print(f"bootstrap_effects (same config and seed): {effects_s:.3f} s; "
          f"finite {ci_finite}; against the loop fits' total effects: max "
          f"diff {ci_err:.3e} (tolerance {ATOL_ADJ}; largest |effect| "
          f"{float(loop_effs.abs().max()):.3f}); significant effects "
          f"{len(ci.significant_effects(0.1))}")
    if not ci_finite or ci_err > ATOL_ADJ:
        fail("bootstrap_effects disagrees with the loop fits' effects")
    # The same solves against an independent reference on the card.
    gamma = d_b * 2.0**-24 / (1.0 - d_b * 2.0**-24)
    eye_b = torch.eye(d_b, dtype=torch.float64, device=dev)
    solve_err, solve_rel, solve_ratio = 0.0, 0.0, 0.0
    for r, t32 in zip(seen["loop"], loop_effs):
        l64 = eye_b - r.adjacency.double()
        t64 = torch.linalg.inv(l64)
        err = (t32.double() - t64).abs()
        bound = gamma * (t64.abs() @ l64.abs() @ t32.double().abs())
        solve_err = max(solve_err, float(err.max()))
        solve_rel = max(solve_rel, float((err / t64.abs().clamp_min(1.0))
                                         .max()))
        solve_ratio = max(solve_ratio, float(
            ((err - SOLVE_ABS_FLOOR) / bound.clamp_min(1e-300)).max()))
    print(f"total effects of the {n_boot} loop fits (float32 triangular "
          f"solves on the card) against float64 inv(I - B): max abs err "
          f"{solve_err:.3e}, max err / max(1, |T|) {solve_rel:.3e}; largest "
          f"share of the componentwise bound gamma_d |T| |I - B| |T32| "
          f"(+{SOLVE_ABS_FLOOR}) {solve_ratio:.3e} (must be <= 1)")
    if not solve_ratio <= 1.0:
        fail("the card's total-effect solves exceed their error bound")
    del seen, fits_v, fits_l, ci, want_ci, loop_effs

    # The vmap bootstrap again, traced: the idle share is 1 - device busy /
    # the untraced wall time of the "auto" run above (one untraced run, to
    # keep the script's time as the serving phase joined it).
    def vmap_bootstrap():
        bootstrap.bootstrap_lingam(gt_b.data, strategy="vmap", **boot_kw)

    boot_walls = [vmap_s]
    boot_wall = float(np.median(boot_walls))
    b_wall, b_busy, b_kernels = device_busy(vmap_bootstrap)
    if b_busy is None:
        boot_idle, boot_b1_s = None, None
        print("bootstrap traced: torch.profiler shows no device time; idle "
              "share not measured")
    else:
        boot_idle = 1.0 - b_busy / boot_wall
        boot_b1_s = sum(t for name, t in b_kernels.items()
                        if "pair_partials" in name or "reduce_slabs" in name)
        top = sorted(b_kernels.items(), key=lambda kv: -kv[1])[:6]
        print("bootstrap traced, device time by kernel: " + "; ".join(
            f"{name[:60]} {t:.3f} s" for name, t in top))
        print(f"bootstrap (vmap): device busy {b_busy:.3f} s (traced), of "
              f"which B1 {boot_b1_s:.3f} s; idle share {boot_idle:.1%} of "
              f"the untraced run {boot_wall:.3f} s "
              f"({', '.join(f'{w:.3f}' for w in boot_walls)} s); "
              f"{1.0 - b_busy / b_wall:.1%} of the traced {b_wall:.3f} s")
    # B1 at the batched shape of the bootstrap's first step: all 32
    # resamples at full width, against 32 single launches.
    xs_b, c_b, _, _ = ordering.step_standardize(x_b[idx_b],
                                                ordering.LocalReducer())
    t0 = time.perf_counter()
    k1, k2 = ops.pairwise_moments(xs_b, c_b)
    p1, p2 = pairwise_stats.pairwise_moment_sums_plain(xs_b.double(),
                                                       c_b.double())
    batched_err = max(max(offdiag_err(k1[k], p1[k] / m_b),
                          offdiag_err(k2[k], p2[k] / m_b))
                      for k in range(n_boot))
    print(f"B1 batched at ({n_boot}, {m_b}, {d_b}) against the batched plain "
          f"version in float64: max off-diagonal err {batched_err:.3e} "
          f"(tolerance {ATOL_F32}), {time.perf_counter() - t0:.1f} s")
    if not batched_err <= ATOL_F32:
        fail(f"batched B1 disagrees with its float64 plain version at "
             f"({n_boot}, {m_b}, {d_b}): {batched_err}")
    del k1, k2, p1, p2
    batched_ms = cuda_ms(lambda: ops.pairwise_moments(xs_b, c_b), 10)
    singles_ms = cuda_ms(lambda: [ops.pairwise_moments(xs_b[k], c_b[k])
                                  for k in range(n_boot)], 5)
    batched_bound = moment_bound_ms(
        d_b, d_b, m_b * n_boot,
        4 * n_boot * (m_b * d_b + 3 * d_b * d_b), sms, clock_mhz)
    print(f"B1 batched at ({n_boot}, {m_b}, {d_b}): {batched_ms:.3f} ms per "
          f"launch (median of 10, CUDA events); the same sums as {n_boot} "
          f"single launches {singles_ms:.3f} ms; bound {batched_bound[0]:.3f} "
          f"ms (special-function ops {batched_bound[1]:.3f} ms, bytes "
          f"{batched_bound[2]:.3f} ms)")
    del xs_b, c_b, x_b, idx_b

    # 10. the serving engine at the stock panel's width: the plan search
    # of its warm-up, a burst of fit requests, 8 monitored streams with
    # batched refits and a drift break, and a micro-batch of queries.
    t_serve = time.perf_counter()
    tune_dir = tempfile.mkdtemp(prefix="repro-torch-tune-")
    os.environ["REPRO_TORCH_TUNE_CACHE"] = os.path.join(tune_dir,
                                                        "plans.json")
    tune_cache.reset_table()
    engine = serve_engine.CausalDiscoveryEngine(
        api.FitConfig(compaction="staged"), batch_size=8)
    # The reference's monitor settings, with alert rings large enough that
    # no alert of the run is dropped before poll_alerts reads it.
    stream_cfg = StreamConfig(d=sw.d, chunk=sw.chunk,
                              window_chunks=sw.window_chunks, lags=sw.lags,
                              refit_every=sw.refit_every,
                              monitor=MonitorConfig(max_pending=4096,
                                                    history=4096))
    searches = []
    real_autotune = autotune.autotune_op

    def seen_autotune(*args, **kw):
        searches.append(real_autotune(*args, **kw))
        return searches[-1]

    autotune.autotune_op = seen_autotune
    t0 = time.perf_counter()
    plans = engine.warmup([(wv.m, wv.d)], tune_mode="auto",
                          streams=[stream_cfg])
    warm_s = time.perf_counter() - t0
    n_searched = len(searches)
    t0 = time.perf_counter()
    plans_again = engine.warmup([(wv.m, wv.d)], tune_mode="auto",
                                streams=[stream_cfg], compile=False)
    warm2_s = time.perf_counter() - t0
    autotune.autotune_op = real_autotune
    warm_rows = []
    for tp in searches:
        heur = next(m.plan.tile for m in tp.measurements
                    if m.plan.source == "heuristic")
        times = {m.plan.tile: m.seconds * 1e3 for m in tp.measurements}
        warm_rows.append({"op": tp.op, "shape": list(tp.shape),
                          "batch": tp.batch, "heuristic": heur,
                          "chosen": tp.best.tile, "ms": times})
        print(f"warm-up search {tp.op} {tuple(tp.shape)} batch {tp.batch}: "
              + ", ".join(f"T={t} {v:.3f} ms" for t, v in times.items())
              + f" per launch (heuristic T={heur}); chosen T={tp.best.tile}"
              f"; every candidate's sums bit-equal to the heuristic plan's")
    print(f"warm-up: {warm_s:.2f} s ({n_searched} searches); again "
          f"{warm2_s:.2f} s ({len(searches) - n_searched} searches); plans "
          + "; ".join(f"{k.split('/', 2)[2]}: T={p.tile} ({p.source})"
                      for k, p in plans.items()))
    if {tp.op for tp in searches} != {"pairwise_moments",
                                      "pairwise_moment_sums_chunked"}:
        fail(f"the warm-up did not search both ops: {searches}")
    if len(searches) != n_searched or plans_again != plans:
        fail("the second warm-up measured again")
    # The host cost of one launch's plan decision (a table hit).
    t0 = time.perf_counter()
    for _ in range(10_000):
        tune_registry.dispatch("pairwise_moment_sums_chunked",
                               (sw.chunk * sw.window_chunks, sw.d),
                               chunk=sw.chunk, batch=8, device=dev)
    dispatch_us = (time.perf_counter() - t0) / 10_000 * 1e6
    print(f"dispatch: {dispatch_us:.2f} us per launch's plan (a table hit, "
          f"mean of 10,000)")

    # Fit burst: 8 requests at the stock panel's size, 3 at (20,000, 100):
    # one fit_many per shape.
    mid = (20_000, 100)
    gts = [simulate_lingam(m=wv.m, d=wv.d, seed=s) for s in range(8)]
    gts += [simulate_lingam(m=mid[0], d=mid[1], seed=s) for s in range(3)]
    reqs = [serve_engine.FitRequest(data=g.data) for g in gts]
    fit_calls = []
    real_fit_many = batched.fit_many

    def seen_fit_many(xs, *args, **kw):
        fit_calls.append(tuple(xs.shape))
        return real_fit_many(xs, *args, **kw)

    batched.fit_many = seen_fit_many
    pairwise_stats.launches = 0
    pairwise_stats.rows_launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.run(reqs)
    burst_s = time.perf_counter() - t0
    burst_b1 = pairwise_stats.launches
    burst_b2 = pairwise_stats.rows_launches
    batched.fit_many = real_fit_many
    requests_per_s = len(reqs) / burst_s
    print(f"fit burst: {len(reqs)} requests in {burst_s:.3f} s, "
          f"{requests_per_s:.2f} requests/s; fit_many calls "
          f"{fit_calls}; B1 launches {burst_b1}, B2 launches {burst_b2}")
    if fit_calls != [(8, wv.m, wv.d), (3, *mid)] or (
            burst_b1 != wv.d + mid[1] or burst_b2):
        fail("expected one fit_many per shape and one B1 launch per "
             "ordering step")
    serve_cfg = engine.config
    single_s, adj_err, burst_parted = [], 0.0, []
    for k, (r, g) in enumerate(zip(reqs, gts)):
        x_k = torch.from_numpy(np.ascontiguousarray(r.data)).to(dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one = api.fit_fn(x_k, serve_cfg)
        o1 = one.order.cpu().numpy()
        single_s.append(time.perf_counter() - t0)
        if np.array_equal(o1, r.result.order):
            adj_err = max(adj_err, float(np.abs(
                one.adjacency.cpu().numpy() - r.result.adjacency).max()))
        else:
            p, ratio = parting_tie(x_k, o1, r.result.order,
                                   ordering.LocalReducer(), ATOL_F32)
            burst_parted.append((k, p, ratio))
        if not (np.isfinite(r.result.adjacency).all() and np.array_equal(
                np.sort(r.result.order), np.arange(g.data.shape[1]))):
            fail(f"fit request {k}: malformed result")
    print(f"fit burst against api.fit_fn on each request alone "
          f"({sum(single_s):.3f} s for the {len(reqs)} fits): orders equal "
          f"in {len(reqs) - len(burst_parted)} of {len(reqs)}"
          + "".join(f"; request {k} parts at position {p} at a tie (score "
                    f"gap {r:.3f} of its tolerance)"
                    for k, p, r in burst_parted)
          + f"; adjacency max diff {adj_err:.3e} where the orders agree "
          f"(tolerance {ATOL_ADJ}); true edges forward in the served orders "
          + ", ".join(f"{forward_share(r.result.order, g.adjacency):.3f}"
                      for r, g in zip(reqs, gts)))
    if adj_err > ATOL_ADJ:
        fail("a served fit differs from the single fit")

    # Streams: 8 monitored sessions at varlingam-stream-487, posted round
    # robin; session 3 carries a noise-scale break after its window fills.
    n_rows = sw.chunk * n_chunks + 8
    t0 = time.perf_counter()
    base = simulate_var_stocks(m=7 * n_rows, d=sw.d, seed=1)[0]
    series = [base[k * n_rows:(k + 1) * n_rows] for k in range(7)]
    brk = simulate_var_breaks(m=n_rows, d=sw.d, kind="noise_scale",
                              at=sw.chunk * (sw.window_chunks + 1),
                              edge_prob=0.01, seed=0)
    series.insert(3, brk.series)
    print(f"stream data on the host ({time.perf_counter() - t0:.1f} s): 7 "
          f"stationary slices of simulate_var_stocks(m={7 * n_rows}, "
          f"d={sw.d}, seed=1) and, as session 3, simulate_var_breaks(m="
          f"{n_rows}, kind='noise_scale', at={brk.at}, edge_prob=0.01): "
          f"variable {brk.variable}'s noise x3 from chunk "
          f"{brk.at // sw.chunk}")
    sids = [engine.open_stream(stream_cfg) for _ in series]
    flushes, fmfs_calls = [], []
    real_fmfs = batched.fit_many_from_stats
    real_flush = engine.flush_streams

    def seen_fmfs(xs, *args, **kw):
        fmfs_calls.append(tuple(xs.shape))
        return real_fmfs(xs, *args, **kw)

    def timed_flush():
        b2, n_calls = pairwise_stats.rows_launches, len(fmfs_calls)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_flush()
        torch.cuda.synchronize()
        flushes.append({"sessions": len(out), "s": time.perf_counter() - t0,
                        "b2": pairwise_stats.rows_launches - b2,
                        "calls": fmfs_calls[n_calls:],
                        "errors": [e.summary()
                                   for e in engine.last_flush_errors]})
        return out

    batched.fit_many_from_stats = seen_fmfs
    engine.flush_streams = timed_flush

    def post(s, k):
        """One session's post of chunk k: (deltas, host seconds)."""
        n_f = len(flushes)
        t0 = time.perf_counter()
        out = engine.post_chunk(sids[s], series[s][k * sw.chunk:(k + 1)
                                                   * sw.chunk])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        return out, (dt if len(flushes) == n_f else None)

    pairwise_stats.launches = 0
    pairwise_stats.rows_launches = 0
    post_unarmed, post_armed = [], []
    for k in range(n_chunks - 1):
        for s in range(len(sids)):
            armed = engine.stream_session(sids[s]).monitor.armed
            _, dt = post(s, k)
            if dt is not None:
                (post_armed if armed else post_unarmed).append(dt)
    real_flush_n = len(flushes)
    engine.flush_streams()  # drain: every session's window is refitted
    # The last round: the 8th post makes all 8 sessions due, and flushes
    # them in one batched refit, traced for the device's busy time.
    for s in range(len(sids) - 1):
        _, dt = post(s, n_chunks - 1)
        post_armed.append(dt)
    traced = {}

    def last_post():
        traced["out"], _ = post(len(sids) - 1, n_chunks - 1)

    f_wall, f_busy, f_kernels = device_busy(last_post)
    serve_b1 = pairwise_stats.launches
    serve_b2 = pairwise_stats.rows_launches
    batched.fit_many_from_stats = real_fmfs
    del engine.flush_streams
    final = flushes[-1]
    for j, f in enumerate(flushes):
        print(f"flush {j}: {f['sessions']} sessions in {f['s']:.3f} s"
              f"{' (traced)' if f is final else ''}; fit_many_from_stats "
              f"calls {f['calls']}; B2 launches {f['b2']}; errors "
              f"{f['errors']}")
    if (len(traced["out"]) != len(sids) or final["sessions"] != len(sids)
            or len(final["calls"]) != 1):
        fail("the last post did not flush all 8 sessions in one refit")
    for f in flushes:
        if (f["errors"] or f["b2"] != sw.d * len(f["calls"])
                or sum(c[0] for c in f["calls"]) != f["sessions"]):
            fail("a flush is not one fit_many_from_stats per window shape "
                 "with one B2 launch per ordering step")
    if serve_b1 or serve_b2 != sw.d * len(fmfs_calls):
        fail(f"stream B2 launches {serve_b2} (B1 {serve_b1}) against "
             f"{sw.d} per batched refit")
    full = [f["s"] for f in flushes[:real_flush_n]
            if f["sessions"] == len(sids) and len(f["calls"]) == 1]
    flush_s = float(np.median(full))
    if f_busy is None:
        flush_idle = None
        print("traced flush: torch.profiler shows no device time; idle "
              "share not measured")
    else:
        flush_idle = 1.0 - f_busy / flush_s
        top = sorted(f_kernels.items(), key=lambda kv: -kv[1])[:5]
        print("traced flush, device time by kernel: " + "; ".join(
            f"{name[:60]} {t * 1e3:.1f} ms" for name, t in top))
        print(f"traced flush of 8: device busy {f_busy:.3f} s; idle share "
              f"{flush_idle:.1%} of the untraced median {flush_s:.3f} s "
              f"({', '.join(f'{v:.3f}' for v in full)} s); "
              f"{1.0 - f_busy / f_wall:.1%} of the traced {f_wall:.3f} s")
    # The last flush's deltas against each session's own refit_now on the
    # same window (a refit leaves the window's state as it is).
    refit_s, stream_adj, stream_parted = [], 0.0, []
    red_w = ordering.LocalReducer(moment_chunk=sw.chunk)
    for s, sid in enumerate(sids):
        sess = engine.stream_session(sid)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solo = sess.rolling.refit()
        torch.cuda.synchronize()
        refit_s.append(time.perf_counter() - t0)
        got, want = (f.result.order.cpu().numpy()
                     for f in (sess.last_fit, solo))
        if np.array_equal(got, want):
            stream_adj = max(stream_adj, max(
                float(np.abs(a - b).max())
                for a, b in zip(sess.last_fit.thetas, solo.thetas)))
        else:
            plan = sess.rolling.prepare_refit()
            x_w = api.standardize_from_stats(plan.resid, plan.resid_mean,
                                             plan.resid_cov)
            p, ratio = parting_tie(x_w, want, got, red_w, ATOL_F32)
            stream_parted.append((s, p, ratio))
    print(f"batched flush of 8 against each session's refit_now on the same "
          f"window: orders equal in {len(sids) - len(stream_parted)} of "
          f"{len(sids)}" + "".join(
              f"; session {s} parts at position {p} at a tie (score gap "
              f"{r:.3f} of its tolerance)" for s, p, r in stream_parted)
          + f"; thetas max diff {stream_adj:.3e} where the orders agree "
          f"(tolerance {ATOL_ADJ}); flush {flush_s:.3f} s against "
          f"{sum(refit_s):.3f} s for the 8 refits one by one "
          f"({', '.join(f'{v:.3f}' for v in refit_s)} s)")
    if stream_adj > ATOL_ADJ:
        fail("a batched refit differs from the session's own refit")
    # The monitor's own cost on one post: its drift transform, the copy of
    # the statistics to the host and the CUSUM update, on the last chunk.
    sess = engine.stream_session(sids[0])
    rows_last = series[0][(n_chunks - 2) * sw.chunk:n_chunks * sw.chunk]
    cs = stats.from_chunk(torch.from_numpy(
        window.lagged_rows(rows_last[sw.chunk - sw.lags:], sw.lags)).to(dev))
    mon = copy.deepcopy(sess.monitor)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        mon.update(cs, chunk_index=0)
    monitor_ms = (time.perf_counter() - t0) / 20 * 1e3
    post_unarmed_s = float(np.median(post_unarmed))
    post_armed_s = float(np.median(post_armed))
    print(f"seconds per post: {post_armed_s:.4f} monitored (median of "
          f"{len(post_armed)} posts that did not flush), {post_unarmed_s:.4f}"
          f" before the monitors armed ({len(post_unarmed)} posts, windows "
          f"filling); the monitor's update alone {monitor_ms:.3f} ms (one "
          f"device-to-host copy of the chunk's count and 3 x {sw.d} "
          f"statistics)")
    alerts = engine.poll_alerts()
    again = engine.poll_alerts()
    alert_rows = {}
    for sid in sids:
        mine = [a for a in alerts if a.sid == sid]
        if not mine:
            continue
        kinds = {k: sum(a.kind == k for a in mine)
                 for k in sorted({a.kind for a in mine})}
        variables = sorted({a.variable for a in mine})
        alert_rows[sid] = len(mine)
        print(f"alerts of {sid}{' (the break)' if sid == sids[3] else ''}: "
              f"{len(mine)} {kinds} at chunks "
              f"{sorted({a.chunk_index for a in mine})} on "
              f"{len(variables)} variables (lowest {variables[:5]}, highest "
              f"{variables[-3:]}), statistics "
              f"{min(a.stat for a in mine):+.1f} to "
              f"{max(a.stat for a in mine):+.1f}")
    for a in alerts:
        if a.sid == sids[3] and a.variable == brk.variable:
            print(f"alert {a.sid}: {a.summary()}")
    on_break = [a for a in alerts if a.sid == sids[3]]
    false_alarms = [a for a in alerts if a.sid != sids[3]]
    hit = [a for a in on_break if a.variable == brk.variable
           and a.chunk_index > brk.at // sw.chunk]
    print(f"poll_alerts: {len(alerts)} alerts, {len(on_break)} on session 3 "
          f"({len(hit)} on its broken variable {brk.variable} after the "
          f"break, first at chunk "
          f"{min((a.chunk_index for a in hit), default=None)}), "
          f"{len(false_alarms)} on the 7 stationary sessions (false alarms);"
          f" a second poll returned {len(again)}")
    if not hit or again:
        fail("the break was not alerted on its variable, or an alert was "
             "delivered twice")

    # Queries: 16 mixed requests against the fit results and session ids.
    fitted = [r.result for r in reqs[:8]]
    rng_q = np.random.default_rng(0)
    queries = (
        [query_lib.EffectQuery(graph=g) for g in fitted[:3]]
        + [query_lib.EffectQuery(graph=sids[s]) for s in (0, 3)]
        + [query_lib.InterventionQuery(graph=fitted[0],
                                       do={int(gts[0].order[0]): 1.0}),
           query_lib.InterventionQuery(graph=fitted[3], do={
               5: -1.0, wv.d // 3: 2.0}),
           query_lib.InterventionQuery(graph=fitted[4], do={wv.d // 5: 1.0}),
           query_lib.InterventionQuery(graph=sids[1], do={0: 0.5}),
           query_lib.InterventionQuery(graph=sids[2], do={})]
        + [query_lib.RCAQuery(graph=fitted[k], rows=gts[k].data[:64],
                              target=t)
           for k, t in ((0, 10), (5, wv.d // 2), (6, None), (7, 1))]
        + [query_lib.RCAQuery(graph=sids[s], rows=series[s][-64:],
                              target=t)
           for s, t in ((3, brk.variable), (4, 3))])
    rng_q.shuffle(queries)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.query(queries)
    query_s = time.perf_counter() - t0

    def query_err(got, want):
        want = np.asarray(want, np.float64)
        return float(np.abs(got - want).max()) / max(1.0, float(
            np.abs(want).max()))

    def gamma(n):
        return n * 2.0**-24 / (1.0 - n * 2.0**-24)

    q_err, solve_q, rca_q = {}, 0.0, 0.0
    for q in queries:
        res = q.graph.result
        if isinstance(q, query_lib.EffectQuery):
            kind = "effect"
            direct = effects.total_effects(res).cpu().numpy()
            err = query_err(q.effects, direct)
            dq = q.graph.d
            l64 = (torch.eye(dq, dtype=torch.float64, device=dev)
                   - res.adjacency.double())
            t64 = torch.linalg.inv(l64)
            t32 = torch.from_numpy(q.effects).to(dev).double()
            bound = gamma(dq) * (t64.abs() @ l64.abs() @ t32.abs())
            solve_q = max(solve_q, float(((t32 - t64).abs()
                                          - SOLVE_ABS_FLOOR)
                                         .div(bound.clamp_min(1e-300))
                                         .max()))
        elif isinstance(q, query_lib.InterventionQuery):
            kind = "intervention"
            mean = None if q.graph.sid is None else q.graph.mean
            mu, cov = intervene.interventional_moments(res, q.do, mean=mean)
            err = max(query_err(q.mean, mu), query_err(q.cov, cov))
        else:
            kind = "rca"
            direct = rca.attribute(
                api.FitResult(res.order, res.adjacency, q.graph.noise_var),
                q.rows, mean=q.graph.mean, target=q.target)
            err = query_err(q.result.scores, direct.scores)
            # A float32 product over d terms carries rounding up to
            # gamma_{d+2} |x - mu| |I - B|^T (Higham, Thm 3.5) and the
            # batched and single products round differently: hold both
            # answers to the float64 scores within that componentwise
            # bound (plus 4 ulps for the scaling), and the contributions
            # to e64 * T64[target] within the product's and the
            # row solve's bounds (gamma_d |t| |I - B| |T|).
            dq = q.graph.d
            l64 = (torch.eye(dq, dtype=torch.float64, device=dev)
                   - res.adjacency.double())
            xc = (torch.from_numpy(q.rows).to(dev).double()
                  - q.graph.mean.double())
            e64 = xc @ l64.T
            be = gamma(dq + 2) * (xc.abs() @ l64.abs().T)
            sd = torch.sqrt(torch.clamp(q.graph.noise_var.double(),
                                        min=1e-12))
            s64 = e64 / sd
            bs = be / sd + 4 * 2.0**-24 * s64.abs() + SOLVE_ABS_FLOOR
            got = [(a.scores, s64, bs) for a in (q.result, direct)]
            if q.target is not None:
                t64 = torch.linalg.inv(l64)
                trow = t64[q.target]
                bt = gamma(dq) * (trow.abs() @ l64.abs() @ t64.abs())
                c64 = e64 * trow
                bc = (be * (trow.abs() + bt) + e64.abs() * bt
                      + 2 * 2.0**-24 * c64.abs() + SOLVE_ABS_FLOOR)
                got += [(a.contributions, c64, bc)
                        for a in (q.result, direct)]
                err = max(err, query_err(q.result.contributions,
                                         direct.contributions))
            for ans, want, bound in got:
                rca_q = max(rca_q, float(
                    ((torch.from_numpy(ans).to(dev).double() - want).abs()
                     / bound).max()))
        if not all(np.isfinite(np.asarray(a)).all() for a in (
                (q.effects,) if kind == "effect" else (q.mean, q.cov)
                if kind == "intervention" else (q.result.scores,))):
            fail(f"a {kind} answer is not finite")
        q_err[kind] = max(q_err.get(kind, 0.0), err)
    print(f"queries: {len(queries)} mixed (5 effect, 5 intervention, 6 RCA; "
          f"fit results and session ids) in {query_s:.3f} s; max |answer - "
          f"the direct function on that graph| / max(1, max |direct|): "
          + ", ".join(f"{k} {v:.3e}" for k, v in q_err.items())
          + f" (tolerance {ATOL_QUERY} for effects and interventions); "
          f"effects against float64 inv(I - B): largest share of the "
          f"componentwise bound {solve_q:.3e}; RCA scores and "
          f"contributions, batched and direct, against float64: largest "
          f"share of their componentwise bounds {rca_q:.3e} (each must be "
          f"<= 1)")
    if (max(q_err["effect"], q_err["intervention"]) > ATOL_QUERY
            or not solve_q <= 1.0 or not rca_q <= 1.0):
        fail("a query answer disagrees with its direct function")
    del engine, reqs, gts, series, base, queries, fitted
    shutil.rmtree(tune_dir)
    del os.environ["REPRO_TORCH_TUNE_CACHE"]
    tune_cache.reset_table()
    serve_s = time.perf_counter() - t_serve
    print(f"serving phase: {serve_s:.1f} s")

    # 12. the paper's experiments
    (experiments_launches, gene_ms, gene_bound, gene_shape,
     gene_err) = paper_experiments(dev, cuda_ms, sms, clock_mhz)

    # 11. kernels line (printed after phase 12, whose launches it
    # reports): launches are those of each kernel's path (the
    # lingam-1m-100 fit, the rolling stream, B3's entry point; for B1 also
    # the vmap bootstrap and the serving engine's fit burst, for B2 the
    # serving engine's batched refits).
    def regs(*entries):
        return {e: ptxas[e] for e in entries if e in ptxas}

    b12_ptxas = regs("pair_partials<4>", "pair_partials<2>",
                     "pair_partials<1>", "reduce_slabs")
    print(json.dumps({"kernels": [{
        "name": "pairwise_moments",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/pairwise_moments.cu",
        "replaces": "src/repro/kernels/pairwise_stats.py:172",
        "launches": fits["none"][1],
        "max_abs_err": full_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "library_ms": None,
        "shape": f"{m}x{d}",
        "ms_3999x487": var_b1_ms,
        "plain_ms_3999x487": var_b1_plain_ms,
        "bound_ms_3999x487": var_b1_bound[0],
        "max_abs_err_3999x487": var_err,
        "batched_ms": batched_ms,
        "batched_bound_ms": batched_bound[0],
        "batched_shape": f"{n_boot}x{m_b}x{d_b}",
        "batched_max_abs_err": batched_err,
        "batched_singles_ms": singles_ms,
        "bootstrap_launches": boot_launches,
        "bootstrap_loop_launches": loop_launches,
        "bootstrap_vmap_s": vmap_s,
        "bootstrap_loop_s": loop_s,
        "bootstrap_idle_share": boot_idle,
        "bootstrap_vmap_peak_bytes": peak_bytes["vmap"],
        "bootstrap_peak_model_bytes": peak_model,
        "bootstrap_loop_peak_bytes": peak_bytes["loop"],
        "serving_launches": burst_b1,
        "serving_fit_burst_s": burst_s,
        "serving_requests_per_s": requests_per_s,
        "warmup_search": [r for r in warm_rows
                          if r["op"] == "pairwise_moments"],
        "experiments_launches": experiments_launches,
        "gene_ms": gene_ms,
        "gene_bound_ms": gene_bound[0],
        "gene_shape": gene_shape,
        "gene_max_abs_err": gene_err,
        "ptxas": b12_ptxas,
    }, {
        "name": "pairwise_moment_sums_rows",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/pairwise_moments.cu",
        "replaces": "src/repro/kernels/pairwise_stats.py:113",
        "launches": stream_launches,
        "max_abs_err": win_err,
        "ms": step_ms,
        "plain_ms": step_plain_ms,
        "bound_ms": step_bound[0],
        "bound_by": ("operations" if step_bound[1] >= step_bound[2]
                     else "bytes"),
        "library_ms": None,
        "shape": f"{m_w}x{d_w} in {n_slabs} slabs of {sw.chunk}",
        "per_slab_launches_ms": per_slab_ms,
        "slab_ms": rows_ms,
        "slab_bound_ms": rows_bound[0],
        "refit_kernel_ms": refit_b2_s * 1e3,
        "refit_idle_share": refit_idle,
        "refit_s": refit_wall,
        "refit_traced_s": prof_wall,
        "serving_launches": serve_b2,
        "serving_flush_s": flush_s,
        "serving_refits_one_by_one_s": sum(refit_s),
        "serving_flush_idle_share": flush_idle,
        "serving_post_s": post_armed_s,
        "serving_monitor_update_ms": monitor_ms,
        "serving_dispatch_us": dispatch_us,
        "warmup_search": [r for r in warm_rows
                          if r["op"] == "pairwise_moment_sums_chunked"],
        "ptxas": b12_ptxas,
    }, {
        "name": "fused_moment_sums",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fused_moments.cu",
        "replaces": "src/repro/kernels/fused_stats.py:69",
        "launches": fused_launches,
        "max_abs_err": fused["float32"]["err"],
        "ms": fused["float32"]["ms"],
        "plain_ms": fused_plain_ms,
        "bound_ms": fused["float32"]["bound"][0],
        "bound_by": ("operations" if fused["float32"]["bound"][1]
                     >= fused["float32"]["bound"][2] else "bytes"),
        "library_ms": None,
        "bfloat16_ms": fused["bfloat16"]["ms"],
        "bfloat16_bound_ms": fused["bfloat16"]["bound"][0],
        "bfloat16_max_abs_err": fused["bfloat16"]["err"],
        "shape": f"{m}x{d}",
        "ptxas": regs("fused_partials<float>", "fused_partials<bfloat16>",
                      "reduce_splits"),
    }]}))
    print(f"chip_smoke: all phases passed in "
          f"{time.perf_counter() - t_start:.1f} s (test shapes worst err: B1 "
          f"{worst:.3e}, batched B1 {worst_batched:.3e}, B2 {worst_rows:.3e} "
          f"per sample, B3 {worst_fused:.3e} per sample)")

    # 13. last line
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
