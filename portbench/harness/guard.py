"""The run-time check that nothing the run loaded is JAX or the JAX package.

Module names are compared by their top-level name (the part before the
first dot) as a whole: ``attention_based_tbn_tpu_torch`` (the port) begins
with ``attention_based_tbn_tpu`` (the JAX package) and is not it.
"""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "attention_based_tbn_tpu")
PROGRAM = "attention_based_tbn_tpu_torch"


def top_level(name: str) -> str:
    return name.split(".", 1)[0]


def found(modules: Iterable[str], forbidden: Iterable[str] = FORBIDDEN) -> List[str]:
    """The forbidden top-level names among ``modules``."""
    banned = set(forbidden)
    return sorted({top_level(m) for m in modules if top_level(m) in banned})


def loaded_forbidden() -> List[str]:
    return found(list(sys.modules))
