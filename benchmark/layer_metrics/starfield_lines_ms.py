"""Time on the CUDA stream of the program's ``masking.lines`` spans
(solving/masking.py::mask_starfield: the masked adaptive threshold, the
median, HOUGH_ORDER, HOUGH_P and the lines drawn), in-stage gaps included,
over the frames the traced window completed, ms a frame."""

from benchmark import program_spans


def read(run):
    return program_spans.per(program_spans.stream_ms(run, "masking.lines"), run.frames)
