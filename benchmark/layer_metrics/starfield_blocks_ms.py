"""Time on the CUDA stream of the program's ``masking.blocks`` spans
(solving/masking.py::mask_starfield: the very dark blocks and the lonely
ones), in-stage gaps included, over the frames the traced window completed,
ms a frame."""

from benchmark import program_spans


def read(run):
    return program_spans.per(program_spans.stream_ms(run, "masking.blocks"), run.frames)
