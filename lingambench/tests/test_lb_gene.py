"""The gene cell on the CPU at a tiny size: the frozen generator against
the port's, the check's drawn-step gaps against the reference's replay,
the float64 lasso against the port's estimator run in float64, the
sound program correct, the faults not, and the lasso's roofline count."""

import json
import types

import numpy as np
import pytest
import torch

from lingambench.lib import reference, reference_gene, roofline, simulate_gene
from lingambench.lib import tracing
from lingambench.lib.tracing import Event
from lingambench.metrics import lasso_roofline_pct
from lingambench.tests import helpers

CELL = "lingam-gene-964.fit"
CONFIG = "configs/lingam-gene-964.json"
SEED = 2147483659
TINY = {"m": 1500, "d": 12, "n_interventions": 4, "edge_prob": 0.3}


def _tiny_checkout(tmp_path):
    root = helpers.tiny_checkout(tmp_path)
    path = root / "lingambench" / CONFIG
    data = json.loads(path.read_text())["data"]
    data["params"] = {"n_interventions": TINY["n_interventions"],
                      "edge_prob": TINY["edge_prob"]}
    helpers.edit_json(path, {"m": TINY["m"], "d": TINY["d"], "data": data})
    return root


def _tiny_data(seed=SEED):
    x, _, b = simulate_gene.simulate_gene_perturb(
        TINY["m"], TINY["d"], TINY["n_interventions"], TINY["edge_prob"],
        seed=seed)
    return x, b


@pytest.mark.parametrize("m,d,n_int,edge_prob", [(1500, 12, 4, 0.3),
                                                 (3000, 200, 40, 0.02)])
def test_the_frozen_generator_equals_the_ports(m, d, n_int, edge_prob):
    from repro_torch.data import simulate as port

    mine = simulate_gene.simulate_gene_perturb(m, d, n_int, edge_prob,
                                               seed=SEED)
    theirs = port.simulate_gene_perturb(m=m, d=d, n_interventions=n_int,
                                        edge_prob=edge_prob, seed=SEED)
    np.testing.assert_array_equal(mine[1], theirs[1])
    np.testing.assert_array_equal(mine[2], theirs[2])
    assert mine[0].dtype == np.float32 and mine[0].flags.c_contiguous
    # the columns' sums associate differently: float32 rounding at most
    np.testing.assert_allclose(mine[0], theirs[0], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("which", ["walk", "reversed"])
def test_order_gap_drawn_equals_the_walks_gaps_at_every_step(which):
    """The QR-rebuilt working data scores every step as the reference's
    sequential replay does: the order the reference walks itself (gaps 0
    up to rounding) and a reversed one (real gaps)."""
    x, _ = _tiny_data()
    xt = torch.as_tensor(x).double()
    own, _ = reference.walk(xt)
    order = own if which == "walk" else own[::-1].copy()
    _, want = reference.walk(xt, order=order)
    got = [reference_gene.step_gap(xt, order, k)[0]
           for k in range(TINY["d"])]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)
    assert reference_gene.order_gap_drawn(
        xt, order, range(TINY["d"])) == pytest.approx(max(want), abs=1e-10)
    if which == "reversed":
        assert max(want) > 1e-3


def test_the_float64_lasso_equals_the_ports_estimator_in_float64():
    from repro_torch.core import pruning

    x, _ = _tiny_data()
    xt = torch.as_tensor(x).double()
    order, _ = reference.walk(xt)
    kw = {"lam": 0.02, "gamma": 1.0, "n_steps": 400}
    port = pruning.adaptive_lasso_adjacency(
        xt, torch.as_tensor(order), **kw).numpy()
    mine = reference_gene.adaptive_lasso(xt, order, **kw).numpy()
    assert reference.rel_err(port, mine) < 1e-7
    # the lasso zeroes some of the least-squares coefficients
    ols = reference.ols_adjacency(reference.covariance(xt), order).numpy()
    assert (mine == 0).sum() > (ols == 0).sum()


def test_drawn_steps_are_step_0_and_distinct_steps_from_the_seed():
    from lingambench.lib import runner

    a = reference_gene.drawn_steps(964, 15, runner.rng_for(SEED, 2))
    b = reference_gene.drawn_steps(964, 15, runner.rng_for(SEED, 2))
    assert a == b and a[0] == 0 and len(set(a)) == 16
    assert all(1 <= k < 964 for k in a[1:])
    assert reference_gene.drawn_steps(12, 15, runner.rng_for(SEED, 2)) == \
        list(range(12))


def test_the_sound_program_is_correct(tmp_path):
    root = _tiny_checkout(tmp_path)
    rc, out, err, last = helpers.run_cell(root, CELL, seconds=0.5)
    assert rc == 0, err
    assert last["correct"] is True, last["checks"]
    assert set(last["checks"]) == {"order_gap_drawn", "lasso_adjacency_err",
                                   "lasso_std_err_q90"}
    assert set(last["metrics"]) == {"fit_s", "setup_s"}


REVERSED_ORDER = """
from repro_torch.core import direct_lingam
_fit = direct_lingam.DirectLiNGAM.fit
def fit(self, x):
    out = _fit(self, x)
    out.causal_order_ = out.causal_order_[::-1].copy()
    return out
direct_lingam.DirectLiNGAM.fit = fit
"""

MOVED_ENTRY = """
from repro_torch.core import direct_lingam
_fit = direct_lingam.DirectLiNGAM.fit
def fit(self, x):
    out = _fit(self, x)
    out.adjacency_[3, 1] += 0.05
    return out
direct_lingam.DirectLiNGAM.fit = fit
"""

OLS_FOR_LASSO = """
from repro_torch.core import pruning
def adaptive_lasso_adjacency(x, order, **kw):
    return pruning.ols_adjacency(x, order)
pruning.adaptive_lasso_adjacency = adaptive_lasso_adjacency
"""


@pytest.mark.parametrize("fault", [REVERSED_ORDER, MOVED_ENTRY,
                                   OLS_FOR_LASSO],
                         ids=["reversed-order", "moved-entry",
                              "ols-for-lasso"])
def test_a_fault_is_not_correct(tmp_path, fault):
    root = _tiny_checkout(tmp_path)
    rc, out, err, last = helpers.run_cell(root, CELL, seconds=0.5,
                                          prelude=fault)
    assert rc == 0, err
    assert last["correct"] is False, last["checks"]


@pytest.mark.parametrize("mode", ["bfloat16", "fista32"])
def test_the_control_reads_far_above_the_program(tmp_path, mode):
    """bfloat16 stands in for the control's lower products on the CPU,
    and float32 sweeps for the precision the configuration rules out:
    each lasso reads far above the sound program's, in raw and in
    correlation units."""
    root = _tiny_checkout(tmp_path)
    rc, out, err, last = helpers.run_cell(root, CELL, seed=7, seconds=0.5)
    assert rc == 0 and last["correct"] is True, err
    x, _ = _tiny_data(seed=7)
    got = reference_gene.control_numbers(
        x, np.arange(TINY["d"]), range(TINY["d"]),
        {"lam": 0.02, "gamma": 1.0, "n_steps": 400}, mode,
        torch.device("cpu"))
    assert ("order_gap_drawn" in got) == (mode != "fista32")
    for name in ("lasso_adjacency_err", "lasso_std_err_q90"):
        program = last["checks"][name]["value"]
        assert got[name] > 10 * program + 1e-12, (name, got, program)


def test_lasso_least_time_counts_the_predecessor_products():
    """A sweep: sum p^2 float64 multiply-adds, and the correlation's
    lower triangle and the iterate read and the iterate written; at d =
    964 the multiply-adds bound it."""
    d = 7
    assert lasso_roofline_pct.useful_fmas(d) == sum(p * p for p in range(d))
    assert lasso_roofline_pct.useful_bytes(d) == 3 * 21 * 8
    assert lasso_roofline_pct.useful_fmas(964) == pytest.approx(
        964 ** 3 / 3, rel=2e-3)
    fma = lasso_roofline_pct.FP64_FMA_PER_S["NVIDIA H100 80GB HBM3"]
    got = lasso_roofline_pct.least_seconds(964, 400, fma, 3.35e12)
    assert got == pytest.approx(400 * lasso_roofline_pct.useful_fmas(964)
                                / fma, rel=1e-12)
    assert got == pytest.approx(3.56e-3, rel=1e-2)
    assert lasso_roofline_pct.least_seconds(2, 1, fma, 3.35e12) == \
        pytest.approx(3 * 8 / 3.35e12)


def test_lasso_roofline_reads_the_prune_lasso_range():
    """400 iterations (the configuration's) at d = 964 over 0.5 s of
    kernels in ``prune.lasso``, and nothing where the range is absent or
    the card has no FP64 rate in the table."""
    assert lasso_roofline_pct.iterations("lasso_roofline_pct.gene") == 400
    metric = types.SimpleNamespace(name="lasso_roofline_pct.gene")
    card = "NVIDIA H100 80GB HBM3"

    def ctx(range_name, name=card):
        ev = [Event("range", "lingambench.op", 0.0, 10.0),
              Event("range", "fit.pruning", 1.0, 9.0),
              Event("range", range_name, 2.0, 8.0),
              Event("launch", "cudaLaunchKernel", 3.0, 3.01, corr=1),
              Event("device", "gemm", 3.1, 3.6, corr=1, device_kind="kernel")]
        s = tracing.summarize(ev, ["lingambench.op", "fit.pruning",
                                   *lasso_roofline_pct.RANGES])
        peaks = types.SimpleNamespace(
            name=name, bytes_per_s=3.35e12,
            sfu_per_s=roofline.sfu_rate(132, 1.98e9))
        return types.SimpleNamespace(trace=s, peaks=peaks, n_ops=1,
                                     shapes=[(65164, 964, 1)])

    want = 100 * lasso_roofline_pct.least_seconds(
        964, 400, lasso_roofline_pct.FP64_FMA_PER_S[card], 3.35e12) / 0.5
    assert lasso_roofline_pct.read(ctx("prune.lasso"), metric) == \
        pytest.approx(want)
    assert lasso_roofline_pct.read(ctx("prune.other"), metric) is None
    assert lasso_roofline_pct.read(ctx("prune.lasso", "other card"),
                                   metric) is None
