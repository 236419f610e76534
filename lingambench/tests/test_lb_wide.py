"""The wide cell on the CPU at a tiny size: the QR reference against the
row-by-row least squares and the Cholesky reference, the sound program
correct, its faults not, and the control far above the program."""

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from lingambench.lib import reference, reference_wide, simulate
from lingambench.tests import helpers

CELL = "lingam-8k-2048.fit"
CONFIG = "configs/lingam-8k-2048.json"
TINY = {"m": 2000, "d": 12}


def _tiny_checkout(tmp_path):
    root = helpers.tiny_checkout(tmp_path)
    helpers.edit_json(root / "lingambench" / CONFIG, TINY)
    return root


def _data(seed=3, m=2000, d=12, edge_prob=0.0244 * 2048 / 12):
    return simulate.simulate_lingam(m, d, edge_prob=min(edge_prob, 0.9),
                                    seed=seed)


def test_qr_least_squares_is_each_rows_regression():
    """One QR of the centered data in causal order gives each variable's
    least squares on its predecessors and its mean squared residual, as
    row-by-row ``np.linalg.lstsq`` and the Cholesky reference give."""
    x, _, order = _data()
    xt = torch.as_tensor(x).double()
    b, v = reference_wide.qr_least_squares(xt, order)
    xc = x.astype(np.float64) - x.astype(np.float64).mean(0)
    want_b = np.zeros_like(b.numpy())
    want_v = np.empty(x.shape[1])
    for k, i in enumerate(order):
        pred = list(order[:k])
        coef = (np.linalg.lstsq(xc[:, pred], xc[:, i], rcond=None)[0]
                if pred else np.zeros(0))
        want_b[i, pred] = coef
        r = xc[:, i] - xc[:, pred] @ coef
        want_v[i] = r @ r / x.shape[0]
    np.testing.assert_allclose(b.numpy(), want_b, rtol=0, atol=1e-10)
    np.testing.assert_allclose(v.numpy(), want_v, rtol=1e-10)
    chol = reference.ols_adjacency(reference.covariance(xt), order)
    np.testing.assert_allclose(b.numpy(), chol.numpy(), rtol=0, atol=1e-9)


def test_the_control_solves_tiles_as_one_stack():
    """The control's tiled float32 normal equations equal the generic
    judge's one-stack control solve."""
    x, _, order = _data(seed=4)
    cov = reference.covariance(torch.as_tensor(x), "bfloat16")
    got = reference_wide.ols_normal_equations(cov, order, tile=5)
    want = reference.ols_adjacency(cov, order, "bfloat16")
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


def test_the_sound_program_is_correct(tmp_path):
    root = _tiny_checkout(tmp_path)
    rc, out, err, last = helpers.run_cell(root, CELL, seconds=0.5)
    assert rc == 0, err
    assert last["correct"] is True, last["checks"]
    assert set(last["checks"]) == {"order_gap_drawn", "adjacency_err",
                                   "resid_var_err"}
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

PERTURBED_B = """
from repro_torch.core import direct_lingam
_fit = direct_lingam.DirectLiNGAM.fit
def fit(self, x):
    out = _fit(self, x)
    i, j = out.causal_order_[5], out.causal_order_[2]
    out.adjacency_[i, j] += 1e-3 * abs(out.adjacency_).max()
    return out
direct_lingam.DirectLiNGAM.fit = fit
"""

SCALED_RESID_VAR = """
from repro_torch.core import direct_lingam
_fit = direct_lingam.DirectLiNGAM.fit
def fit(self, x):
    out = _fit(self, x)
    out.resid_var_ = out.resid_var_ * 1.001
    return out
direct_lingam.DirectLiNGAM.fit = fit
"""


@pytest.mark.parametrize("fault", [REVERSED_ORDER, PERTURBED_B,
                                   SCALED_RESID_VAR],
                         ids=["reversed-order", "perturbed-b",
                              "scaled-resid-var"])
def test_a_fault_is_not_correct(tmp_path, fault):
    root = _tiny_checkout(tmp_path)
    rc, out, err, last = helpers.run_cell(root, CELL, seconds=0.5,
                                          prelude=fault)
    assert rc == 0, err
    assert last["correct"] is False, last["checks"]


def test_the_control_reads_far_above_the_program(tmp_path):
    """bfloat16 stands in for the control's TF32 products on the CPU: its
    adjacency and residual variances read far above the sound
    program's, and its entry point prints one line a seed."""
    root = _tiny_checkout(tmp_path)
    rc, out, err, last = helpers.run_cell(root, CELL, seed=7, seconds=0.5)
    assert rc == 0 and last["correct"] is True, err
    x, _, order = simulate.simulate_lingam(
        TINY["m"], TINY["d"], seed=7,
        **json.loads((root / "lingambench" / CONFIG).read_text())
        ["data"]["params"])
    got = reference_wide.control_numbers(x, order, range(TINY["d"]),
                                         "bfloat16", torch.device("cpu"))
    for name in ("adjacency_err", "resid_var_err"):
        program = last["checks"][name]["value"]
        assert got[name] > 10 * program + 1e-12, (name, got, program)
    code = (f"import sys; sys.path[:0] = [{str(root)!r}, "
            f"{str(helpers.SRC)!r}]\n"
            "import torch\n"
            "from lingambench.lib import reference_wide\n"
            "reference_wide.main(['--seeds', '7,8', '--modes', 'bfloat16'], "
            "device=torch.device('cpu'))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=root)
    lines = [json.loads(s) for s in proc.stdout.splitlines()]
    assert [r["seed"] for r in lines] == [7, 8], proc.stderr
    assert lines[0]["numbers"] == pytest.approx(got)
