"""Push-based coroutines for single-pass sequence consumption.

Mirrors auromat/util/coroutine.py:11-60: N consumers (e.g. scanline plots)
can consume one mapping-sequence pass without materialising the sequence —
the memory-conscious streaming pattern for long frame sequences. A copy
of ``auromat_tpu.util.coroutine``.
"""

import functools


def coroutine(func):
    """Decorator: prime a generator-based coroutine on creation."""

    @functools.wraps(func)
    def start(*args, **kwargs):
        gen = func(*args, **kwargs)
        next(gen)
        return gen

    return start


@coroutine
def broadcast(targets):
    """Send every received item to all target coroutines.

    With a single target, items are forwarded without copies.
    """
    targets = list(targets)
    try:
        while True:
            item = yield
            for t in targets:
                t.send(item)
    except GeneratorExit:
        for t in targets:
            t.close()


def feed(iterable, target):
    """Push all items of an iterable into a coroutine, then close it."""
    for item in iterable:
        target.send(item)
    target.close()


def throw(target, etype, e, tb):
    """Raise an exception inside a coroutine (reference coroutine.py:116)."""
    target.throw(etype(e).with_traceback(tb))
