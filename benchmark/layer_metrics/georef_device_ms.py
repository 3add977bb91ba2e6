"""Time on the CUDA stream of the program's ``georegrid.georef`` spans (the
per-pixel georeference chain of ops/georef.py, in-stage gaps included),
over the frames the traced window completed, ms a frame."""

from benchmark import program_spans


def read(run):
    return program_spans.per(program_spans.stream_ms(run, "georegrid.georef"), run.frames)
