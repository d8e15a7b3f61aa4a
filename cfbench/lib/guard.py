"""The check that a run loaded nothing of JAX or of the JAX package."""

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "implicit_tpu")


def forbidden_modules(names=None):
    """Loaded modules whose top-level name (the part before the first dot)
    is one of FORBIDDEN, compared whole: ``implicit_tpu_torch`` passes,
    ``implicit_tpu.models`` does not."""
    names = sys.modules if names is None else names
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)
