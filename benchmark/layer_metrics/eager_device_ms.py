"""Device time of every kernel that is not one of the program's hand-written
ones (ops/csrc), over the frames the traced window completed, ms a frame:
the eager torch chain of ops/georef.py and ops/regrid.py."""

import re


def read(run):
    if run.trace is None or not run.frames:
        return None
    hand = re.compile(r"\b(%s)\b" % "|".join(map(re.escape, run.handwritten)))
    s = run.trace.kernel_seconds(lambda name: not hand.search(name))
    return s * 1e3 / run.frames if s else None
