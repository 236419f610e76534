"""The check that the run never loaded JAX or the JAX package.

Module names are compared by their top-level name (the part before the
first dot) as a whole word: ``repro_torch`` is the port and allowed,
``repro`` and ``repro.core`` are the JAX package and not.
"""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})


def forbidden(names: Iterable[str], banned=FORBIDDEN) -> List[str]:
    """The names whose top-level name is in ``banned``, sorted."""
    return sorted({n for n in names if n.split(".", 1)[0] in banned})


def loaded_forbidden() -> List[str]:
    """Forbidden modules in this process's ``sys.modules``."""
    return forbidden(list(sys.modules))
