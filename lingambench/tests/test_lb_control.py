"""The control of the check: the plain reference one step below the
configurations' float32 with TF32 off (products in TF32, integrands in
bfloat16: mode ``"lower"``), in the program's place.

On the card, at the cells' own sizes and limits, it must come out not
correct in every cell. Here on the CPU, which has no TF32, bfloat16
stands in for the lower products too, and at a tiny size (where no limit
of the cells applies) it must read far above the sound program on one of
the cell's numbers at least. The cells' readings on three seeds or more
are in PERF.md (``control.py`` on the card)."""

import json
import subprocess
import sys

import pytest
import torch

from lingambench.tests import helpers

CELLS = ["lingam-1m-100.fit", "varlingam-stocks-487.fit",
         "varlingam-stocks-487.stream", "varlingam-stocks-487.bootstrap"]


def _control(root, cell, mode, device, seeds="2147483671,7"):
    code = (
        "import sys, torch\n"
        f"sys.path[:0] = [{str(root)!r}, {str(helpers.SRC)!r}]\n"
        "import importlib.util\n"
        "spec = importlib.util.spec_from_file_location('control', "
        f"{str(root / 'lingambench' / 'control.py')!r})\n"
        "m = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(m)\n"
        f"m.main(['--workload', {cell!r}, '--seeds', {seeds!r}, "
        f"'--modes', {mode!r}], device=torch.device({device!r}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=900, cwd=root).stdout
    return [json.loads(line) for line in out.strip().splitlines()]


def _fails(root, cell, rows):
    from lingambench.lib import report

    limits = json.loads((root / "lingambench" / "limits"
                         / f"{cell}.json").read_text())["limits"]
    limits = {k: v for k, v in limits.items() if k != "stale_refits"}
    return [not report.passed(report.compare(r["numbers"], limits))
            for r in rows]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_reads_far_above_the_program(tmp_path, cell):
    root = helpers.tiny_checkout(tmp_path)
    rows = _control(root, cell, "bfloat16", "cpu", seeds="7")
    rc, out, err, last = helpers.run_cell(root, cell, seed=7, seconds=0.5)
    assert rc == 0 and last["correct"] is True, err
    program = {k: v["value"] for k, v in last["checks"].items()}
    assert any(rows[0]["numbers"][k] > 10 * program[k] + 1e-12
               for k in rows[0]["numbers"]), (rows[0], program)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CPU has no TF32")
    return "cuda"


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct_on_the_card(card, cell):
    rows = _control(helpers.CHECKOUT, cell, "lower", card, seeds="2147483677")
    assert len(rows) == 1 and all(_fails(helpers.CHECKOUT, cell, rows))
