"""The program's own spans of the traced window, for the readers of
``layer_metrics/``: ``auromat_tpu_torch.profiling`` records them while the
traced window's ``torch.profiler`` session is active (the warm-up runs with
it off), and ``spans()`` returns them once the session has closed. A
program without that recorder gives none, and its readers report nothing.
"""

_drained = [None, ()]  # the run last drained, and its spans


def of(run):
    """The spans the program recorded in ``run``'s traced window, drained
    once a run; () where the program records none."""
    if _drained[0] is not run:
        try:
            from auromat_tpu_torch.profiling import spans
        except ImportError:
            spans = tuple
        _drained[:] = [run, tuple(spans())]
    return _drained[1]


def stream_ms(run, name):
    """Time on the CUDA stream of the spans called ``name``, ms in all;
    None where none of them has one (no span, or no CUDA)."""
    ts = [s.device_ms for s in of(run) if s.name == name and s.device_ms is not None]
    return sum(ts) if ts else None


def per(total, count):
    """``total`` over ``count``, None where either is missing."""
    return total / count if total is not None and count else None
