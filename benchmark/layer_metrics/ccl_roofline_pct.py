"""CCL4's and CCL8's (ops/csrc/ccl.cu) least time over their profiled time in
the traced window, %: benchmark/roofline_masking.py reckons the least time
from the frames' shapes and the plain reference's counts."""

from benchmark.roofline_masking import share_pct


def read(run):
    return share_pct(run, "ccl")
