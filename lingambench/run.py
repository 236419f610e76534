"""Run one cell of the port's benchmark once (see README.md):

    python3 lingambench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout that holds the port under ``src/``.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

# Few threads for the host's share of the work: a steadier set-up.
for _var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[_var] = "4"

_HERE = os.path.dirname(os.path.abspath(__file__))
_CHECKOUT = os.path.dirname(_HERE)
sys.path[:] = [_CHECKOUT, os.path.join(_CHECKOUT, "src")] + [
    p for p in sys.path if os.path.abspath(p or ".") != _HERE]

if __name__ == "__main__":
    from lingambench.lib import runner

    sys.exit(runner.main(sys.argv[1:], t_start=T_START))
