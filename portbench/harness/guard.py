"""The check that the measured process never loaded the JAX package or
JAX itself: module names are compared by their top-level part (before the
first dot), whole, so `filodb_tpu_torch` is not `filodb_tpu`."""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "filodb_tpu"})


def forbidden(names: Iterable[str]) -> List[str]:
    return sorted({n for n in names if n.split(".", 1)[0] in FORBIDDEN})


def loaded_forbidden() -> List[str]:
    return forbidden(list(sys.modules))
