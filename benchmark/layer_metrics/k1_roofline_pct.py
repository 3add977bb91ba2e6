"""K1's least time over its profiled time, %: the bytes its launches must
move (benchmark.roofline.k1_bytes, from the shapes and the reference's count
of valid samples) at 3.35 TB/s, against the time of its two kernels
(k1_bin_kernel, k1_finish_kernel) in the traced window."""

import re

from benchmark.roofline import bound_s

K1 = re.compile(r"\bk1_(bin|finish)_kernel\b")


def read(run):
    if run.trace is None or "k1_bytes" not in run.work or not run.requests:
        return None
    s = run.trace.kernel_seconds(lambda name: bool(K1.search(name)))
    return 100.0 * bound_s(run.work["k1_bytes"]) * run.requests / s if s else None
