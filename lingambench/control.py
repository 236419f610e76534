"""The control of the comparison that decides ``correct``: the plain
reference, in a precision below the configurations' float32 with TF32
off, put in the program's place and judged as the program is.

    python3 lingambench/control.py --workload <cell> --seeds 11,12,13 [--modes lower]

For each seed it makes the cell's inputs as a run does, takes the answers
the cell's check would judge (at the timed sizes), has the reference fit
them in each mode, and prints one JSON line of the numbers the check
compares. A limit lies between the program's readings (the benchmark's
own runs) and these. The benchmark's runs do not run this.
"""

import argparse
import json
import os
import sys
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
_CHECKOUT = os.path.dirname(_HERE)
sys.path[:] = [_CHECKOUT, os.path.join(_CHECKOUT, "src")] + [
    p for p in sys.path if os.path.abspath(p or ".") != _HERE]


def main(argv=None, device=None):
    p = argparse.ArgumentParser(prog="lingambench/control.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--modes", default="lower")
    args = p.parse_args(argv)
    import torch

    from lingambench.lib import device as dev
    from lingambench.lib import judge, runner, spec

    cell = spec.load_cell(args.workload)
    if device is None:
        device = dev.require_cards(cell.chips)
    driver = cell.driver()
    for seed in (int(s) for s in args.seeds.split(",")):
        state = driver.setup(runner.Run(cell, seed, device, program=False))
        answers = driver.answers(state, None, runner.rng_for(seed, 1))
        for mode in args.modes.split(","):
            t0 = time.perf_counter()
            ctl = [judge.control(a, mode, device) for a in answers]
            t1 = time.perf_counter()
            numbers = judge.judge(ctl, device, cell.limits["limits"])
            t2 = time.perf_counter()
            print(json.dumps({"workload": cell.name, "seed": seed,
                              "mode": mode, "numbers": numbers,
                              "control_fit_s": t1 - t0,
                              "judge_s": t2 - t1}), flush=True)
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
