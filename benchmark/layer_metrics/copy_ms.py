"""Host-clock duration of the program's copies between host and device
(``*.to_host``, ``*.to_device`` spans), over the requests of the traced
window, ms a request."""

from benchmark import program_spans


def read(run):
    ms = [s.ms for s in program_spans.of(run) if s.name.endswith((".to_host", ".to_device"))]
    return program_spans.per(sum(ms), run.requests) if ms else None
