"""Host-clock duration of the program's ``*.wait`` spans (its blocking reads:
K1's status word, the mosaic finish's fullest cell), over the frames the
traced window completed, ms a frame."""

from benchmark import program_spans


def read(run):
    waits = [s.ms for s in program_spans.of(run) if s.name.endswith(".wait")]
    return program_spans.per(sum(waits), run.frames) if waits else None
