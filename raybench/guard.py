"""The check that no JAX module ran in a benchmark process.

The port (``unity_raytracer_tpu_torch``) is measured; its JAX twin
(``unity_raytracer_tpu``) and JAX itself may not be loaded in the process
that reports a result. Names are compared by their top-level part (before
the first dot) as a whole, so the port's name, which begins with the
twin's, passes.
"""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "unity_raytracer_tpu"})


def forbidden_modules(modules=None) -> list:
    """Sorted top-level names in ``modules`` (default ``sys.modules``)
    that are forbidden."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names}
                  & FORBIDDEN)


class ForbiddenModules(RuntimeError):
    pass


def check() -> None:
    """Raise ``ForbiddenModules`` naming every forbidden module loaded."""
    found = forbidden_modules()
    if found:
        raise ForbiddenModules(
            f"forbidden modules loaded in the benchmark process: {found}")
