"""The import guard: no module of JAX or of the JAX package may be
loaded in a benchmark process.

Names are compared by their top-level part (before the first dot) as a
whole, since the port's name ``dsdneo_tpu_torch`` begins with the JAX
package's ``dsdneo_tpu``.
"""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "dsdneo_tpu")


def top_level(name: str) -> str:
    return name.split(".", 1)[0]


def forbidden(names=None) -> list[str]:
    """The loaded modules (``sys.modules`` by default) whose top-level
    name is one of ``FORBIDDEN``, sorted."""
    names = sys.modules if names is None else names
    return sorted(n for n in names if top_level(n) in FORBIDDEN)
