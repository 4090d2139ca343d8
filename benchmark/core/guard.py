"""The guard against JAX: no run of the benchmark may load JAX or the JAX
package beside the port.

Modules are compared by their top-level name, the part before the first
dot, taken whole: ``rusty_compression_tpu_torch`` begins with the JAX
package's name ``rusty_compression_tpu`` and is allowed.
"""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "rusty_compression_tpu"})


def forbidden_modules(modules=None) -> list[str]:
    """The loaded modules whose top-level name is forbidden, sorted."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".")[0] in FORBIDDEN)


class JaxLoaded(RuntimeError):
    """A forbidden module is in ``sys.modules``."""


def require_no_jax(when: str, modules=None) -> None:
    found = forbidden_modules(modules)
    if found:
        raise JaxLoaded(f"{when}: sys.modules holds {', '.join(found[:20])}"
                        f"{' ...' if len(found) > 20 else ''}; the benchmark "
                        f"runs the port without JAX")
