"""The control: the reference, one precision below what the configuration
states, run in the program's place through a cell's whole run; its numbers
set the upper readings of the cell's limits and ``correct`` must come out
false. The benchmark's own runs never run it.

    python benchmark/control.py --workload <name> --seconds <s> --seeds <n> [<n> ...]

Prints one JSON line a seed: the seed, ``correct`` and each number checked.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import harness  # noqa: E402


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    cell = harness.find_cell(args.workload)
    for seed in args.seeds:
        t0 = time.perf_counter()
        result, run = harness.drive(cell, seed, args.seconds, False, "cuda", t0,
                                    fault=lambda state: state.use_control())
        print(json.dumps({"seed": seed, "correct": result["correct"],
                          "requests": run.requests, "checks": result["checks"]}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
