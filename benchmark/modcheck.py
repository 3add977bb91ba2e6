"""The run's guard against the JAX package: no module whose top-level name
(the part before the first dot, compared whole) is one of these may be
loaded in the process that prints a result. The port's own name starts
with the JAX package's, so a prefix test would be wrong both ways."""

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "auromat_tpu"})


def forbidden_modules(modules=None):
    """Sorted top-level names of loaded modules that are forbidden."""
    names = sys.modules if modules is None else modules
    return sorted({n.split(".", 1)[0] for n in names} & FORBIDDEN)
