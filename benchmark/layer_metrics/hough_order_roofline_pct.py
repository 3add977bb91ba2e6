"""HOUGH_ORDER's (ops/csrc/hough_order.cu) least time over its profiled time in
the traced window, %: benchmark/roofline_masking.py reckons the least time
from the frames' shapes and the plain reference's counts."""

from benchmark.roofline_masking import share_pct


def read(run):
    return share_pct(run, "hough_order")
