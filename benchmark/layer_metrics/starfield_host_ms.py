"""Host-clock time of the program's ``masking.to_device`` (the frame copied
up), ``masking.sigma`` (the star rectangle, its copy down, the noise
estimate) and ``masking.to_host`` (the mask copied down) spans, over the
frames the traced window completed, ms a frame."""

from benchmark import program_spans

HOST = ("masking.to_device", "masking.sigma", "masking.to_host")


def read(run):
    ms = [s.ms for s in program_spans.of(run) if s.name in HOST]
    return program_spans.per(sum(ms), run.frames) if ms else None
