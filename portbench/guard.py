"""The import guard: nothing of JAX may load in a benchmark process.

Modules are compared by their top-level name (the part before the first
dot), whole: ``vectorwave_tpu_torch`` is the program under test and passes,
``vectorwave_tpu`` is the JAX package and fails.
"""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "vectorwave_tpu"})


def forbidden_modules(modules=None) -> list[str]:
    """Names in ``modules`` (default ``sys.modules``) whose top-level name is
    one of :data:`FORBIDDEN`, sorted."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".", 1)[0] in FORBIDDEN)
