"""Least times of the star-field masking's hand-written kernels, and their
share of the traced time.

The counts come from the frame's shape and the plain reference's
trajectory and border counts (``benchmark/reference/masking.py``), never
from the program's, so that the least time is the same whatever
implements a kernel. The byte counts are those the port's kernel table
has used since each kernel came in; the peaks are ``roofline.py``'s.
"""

import re

from benchmark.roofline import F32_FLOP_PER_S, bound_s

# the __global__ functions of each kernel (auromat_tpu_torch/ops/csrc)
KERNELS = {
    "hough_p": ("hough_p_kernel",),
    "hough_order": ("draws_kernel", "tile_sums_kernel", "scan_sums_kernel",
                    "scan_apply_kernel", "scatter_kernel", "chains_kernel"),
    "ccl": ("tile_kernel", "seam_kernel", "flatten_kernel"),
    "contour_trace": ("pack_kernel", "trace_kernel"),
}


def hough_p_s(h, w, candidates, voters, lines, numangle):
    """HOUGH_P: the larger of its bytes at the memory's rate (the visited
    points as int32 x and y, the mask read once, 16 bytes a line, the
    float32 trig table) and its votes at float32's rate (each voter votes
    once an angle, a product and a fused multiply-add: 3 flops)."""
    n_bytes = 8 * candidates + h * w + 16 * lines + 8 * numangle
    return max(bound_s(n_bytes), 3 * voters * numangle / F32_FLOP_PER_S)


def hough_order_s(candidates):
    """HOUGH_ORDER: the visit order written once, int64 a point."""
    return bound_s(8 * candidates)


def ccl_s(h, w):
    """CCL4 and CCL8 of one binarization: each reads the image (a byte a
    pixel) and writes the int32 labels."""
    return 2 * bound_s(5 * h * w)


def contour_trace_s(border_px, components):
    """CONTOUR_TRACE of one binarization: each border pixel read once (the
    pixels of the hole-filled components with a 4-neighbour outside them),
    and a root in and 40 bytes out (doubled area, box, length, count) a
    component."""
    return bound_s(border_px + 44 * components)


def least_s(masked):
    """{kernel: least seconds} of one frame, from the reference's
    ``Masked``."""
    h, w = masked.shape
    c = masked.counts
    return {
        "hough_p": hough_p_s(h, w, masked.candidates, c["voters"], c["lines"],
                             masked.numangle),
        "hough_order": hough_order_s(masked.candidates),
        "ccl": sum(ccl_s(h, w) for _ in masked.binarizations),
        "contour_trace": sum(contour_trace_s(px, n) for n, px in masked.binarizations),
    }


def share_pct(run, kernel):
    """The kernel's least time over its time in the traced window, %; None
    where the trace or the least time is missing, or the kernel never ran.
    ``run.work[kernel + "_least_s"]`` holds the least time of the window's
    requests."""
    key = f"{kernel}_least_s"
    if run.trace is None or key not in run.work:
        return None
    names = re.compile(r"\b(%s)\b" % "|".join(KERNELS[kernel]))
    s = run.trace.kernel_seconds(lambda name: bool(names.search(name)))
    return 100.0 * run.work[key] / s if s else None
