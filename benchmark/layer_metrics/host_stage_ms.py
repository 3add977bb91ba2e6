"""Host-clock time of the program's ``create_mapping`` and ``resample`` root
spans less their copies (``*.to_host``, ``*.to_device``) and the binning
(``resample.bin``), over the requests of the traced window, ms a request:
the library's host stages (masks, bounding box, grid, float64 planes,
uint8 finish)."""

from benchmark import program_spans

ROOTS = ("create_mapping", "resample")


def _left_out(name):
    return name.endswith((".to_host", ".to_device")) or name == "resample.bin"


def read(run):
    spans = program_spans.of(run)
    total, found = 0.0, False
    for s in spans:
        if s.parent < 0 and s.name in ROOTS:
            total, found = total + s.ms, True
        elif s.parent >= 0 and spans[s.parent].name in ROOTS and _left_out(s.name):
            total -= s.ms
    return program_spans.per(total, run.requests) if found else None
