"""The check that a run loaded neither JAX nor the JAX package.

A module counts by its top-level name, the part of its name before the
first dot, compared whole: `regione_tpu_torch` (the port) passes,
`regione_tpu` and `regione_tpu.core` do not.
"""

from __future__ import annotations

import sys

BANNED = ("jax", "jaxlib", "flax", "regione_tpu")


class Banned(RuntimeError):
    def __init__(self, names):
        super().__init__("loaded in the process that reports: "
                         + ", ".join(names))
        self.names = names


def banned_modules(modules=None) -> list[str]:
    """The banned top-level names among `modules` (default: sys.modules)."""
    names = sys.modules if modules is None else modules
    return sorted({n.split(".", 1)[0] for n in names} & set(BANNED))
