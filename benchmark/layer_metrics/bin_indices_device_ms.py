"""Time on the CUDA stream of the program's ``georegrid.bin_indices`` spans
(ops/regrid.py::bin_indices, the mask, the split into K1's row and column
indices), over the frames the traced window completed, ms a frame."""

from benchmark import program_spans


def read(run):
    return program_spans.per(program_spans.stream_ms(run, "georegrid.bin_indices"),
                             run.frames)
