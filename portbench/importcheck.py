"""The benchmark runs the port alone: no process it starts may load JAX or
the JAX package. Names are compared whole, by the part of each loaded
module's name before the first dot, since the port's own name begins with
the JAX package's."""
from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})


def forbidden_loaded(names: Iterable[str] = None) -> List[str]:
    """The top-level names of loaded modules that are forbidden, sorted."""
    names = list(sys.modules) if names is None else names
    return sorted({n.split(".", 1)[0] for n in names}
                  & FORBIDDEN)
