"""Run one benchmark cell of auromat_tpu_torch on the card(s) of this machine.

    python benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is the result as one JSON object; the
numbers checked against the reference, each beside its limit, are the
last lines of standard error. See benchmark/README.md.
"""

import time

T0 = time.perf_counter()  # set-up is timed from here

import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T0))
