"""A copy of the benchmark at tiny sizes, run on the CPU in a process of
its own (the harness's look for a card skipped)."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
CHECKOUT = BENCH.parent
SRC = CHECKOUT / "src"

TINY = {
    "configs/lingam-1m-100.json": {"m": 2000, "d": 8},
    "configs/varlingam-stocks-487.json": {
        "m": 400, "d": 10, "stream": {"chunk": 32, "window_chunks": 4,
                                      "refit_every": 1}},
    "traffic/rolling-8.json": {"sessions": 3, "panel_chunks": 8,
                               "check_sessions": 3},
    "traffic/bootstrap-32.json": {"resamples": 4, "index_sets": 2},
}


def edit_json(path, changes):
    with open(path) as f:
        d = json.load(f)
    d.update(changes)
    with open(path, "w") as f:
        json.dump(d, f, indent=1)


def tiny_checkout(tmp_path) -> Path:
    """``BENCHMARK.json`` and ``lingambench/`` copied under ``tmp_path``,
    with the configurations and traffic cut to a CPU test's size."""
    root = Path(tmp_path) / "checkout"
    shutil.copytree(BENCH, root / "lingambench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(CHECKOUT / "BENCHMARK.json", root / "BENCHMARK.json")
    for rel, changes in TINY.items():
        edit_json(root / "lingambench" / rel, changes)
    return root


def run_cell(root, cell, *, seed=2147483659, seconds=1.0, trace=0,
             prelude="", timeout=600):
    """Run one cell of the copy at ``root`` on the CPU; ``prelude`` is
    Python run first (a fault planted in the port). Returns (exit code,
    stdout, stderr, the last line parsed or None)."""
    code = (
        "import sys, time\n"
        "t = time.perf_counter()\n"
        f"sys.path[:0] = [{str(root)!r}, {str(SRC)!r}]\n"
        "import torch\n"
        f"{prelude}\n"
        "from lingambench.lib import runner\n"
        "sys.exit(runner.main(sys.argv[1:], device=torch.device('cpu'), "
        "t_start=t))\n")
    env = dict(os.environ, OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, "-c", code, "--workload", cell, "--seed", str(seed),
         "--seconds", str(seconds), "--trace", str(trace)],
        capture_output=True, text=True, timeout=timeout, cwd=root, env=env)
    lines = proc.stdout.strip().splitlines()
    try:
        last = json.loads(lines[-1]) if lines else None
    except json.JSONDecodeError:
        last = None
    return proc.returncode, proc.stdout, proc.stderr, last
