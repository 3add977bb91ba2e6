"""The allocator's peak over the window (reset at its start), less the
slots made before it for the answers the check keeps, GiB."""


def read(run):
    return run.peak_window_bytes / 2 ** 30 if run.peak_window_bytes else None
