"""Small decorators (reference: auromat/util/decorators.py), a copy of
``auromat_tpu.util.decorators``.

The device code is functional and needs none of these; they exist for the
host-side OO shells (providers, mappings) and for API parity.
"""

import contextlib
import functools

import numpy as np


def lazy_property(fn):
    """Cache-on-instance read-only property (reference decorators.py
    ``lazy_property``). The value is computed once per instance and stored
    under ``_lazy_<name>``."""
    attr = "_lazy_" + fn.__name__

    @property
    @functools.wraps(fn)
    def wrapper(self):
        if not hasattr(self, attr):
            setattr(self, attr, fn(self))
        return getattr(self, attr)

    return wrapper


def inherit_docs(cls):
    """Copy missing method docstrings from base classes (reference
    decorators.py ``inherit_docs``)."""
    for name, member in vars(cls).items():
        if getattr(member, "__doc__", None):
            continue
        for base in cls.__mro__[1:]:
            parent = getattr(base, name, None)
            if parent is not None and getattr(parent, "__doc__", None):
                try:
                    member.__doc__ = parent.__doc__
                except AttributeError:
                    pass
                break
    return cls


@contextlib.contextmanager
def printoptions(*args, **kwargs):
    """Temporarily set numpy print options (reference decorators.py
    ``printoptions``)."""
    original = np.get_printoptions()
    try:
        np.set_printoptions(*args, **kwargs)
        yield
    finally:
        np.set_printoptions(**original)
