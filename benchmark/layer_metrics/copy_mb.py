"""Bytes the program copied between host and device (the ``nbytes`` of its
``*.to_host`` and ``*.to_device`` spans), over the requests of the traced
window, MB (1e6 bytes) a request."""

from benchmark import program_spans


def read(run):
    n = [s.nbytes for s in program_spans.of(run)
         if s.name.endswith((".to_host", ".to_device")) and s.nbytes is not None]
    return program_spans.per(sum(n) / 1e6, run.requests) if n else None
