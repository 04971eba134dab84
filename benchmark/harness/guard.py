"""The modules a run may not hold: JAX and the JAX package the port was
made from.  Names are compared whole, by their top-level part (the text
before the first dot): glome_tpu_torch begins with glome_tpu and is not
it."""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "glome_tpu")


def top_level(names) -> set:
    return {n.split(".", 1)[0] for n in names}


def forbidden_loaded(modules=None) -> list:
    """The forbidden top-level names among `modules` (default: this
    process's sys.modules), sorted."""
    names = sys.modules if modules is None else modules
    return sorted(top_level(names) & set(FORBIDDEN))
