"""The window's wall time over the frames it completed, ms a frame."""


def read(run):
    return run.window_s * 1e3 / run.frames if run.frames else None
