"""The import guard: no module of JAX, of Flax or of the JAX package
`videoitg_tpu` may be loaded in the process that prints a result. Names are
compared by their whole top-level part (before the first dot), so the port,
`videoitg_tpu_torch`, is not taken for the JAX package."""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "videoitg_tpu"})


def forbidden_modules(names: Iterable[str]) -> List[str]:
    """The loaded module names whose top-level part is forbidden."""
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


def check_imports() -> List[str]:
    return forbidden_modules(list(sys.modules))
