"""Time on the CUDA stream of the program's ``mosaic.finish`` spans (the
grid-sharded step's finish and the mean over the whole grid), over the
requests of the traced window, ms a request."""

from benchmark import program_spans


def read(run):
    return program_spans.per(program_spans.stream_ms(run, "mosaic.finish"), run.requests)
