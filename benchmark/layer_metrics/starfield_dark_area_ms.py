"""Time on the CUDA stream of the program's ``masking.dark_area`` spans
(solving/masking.py::mask_starfield: the gray and the dark-area mask, each
binarization's contour stage), in-stage gaps included, over the frames the
traced window completed, ms a frame."""

from benchmark import program_spans


def read(run):
    return program_spans.per(program_spans.stream_ms(run, "masking.dark_area"), run.frames)
