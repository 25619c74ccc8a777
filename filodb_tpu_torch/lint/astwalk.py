"""Memoized ``ast.walk`` for the lint engine's hot sweeps.

The gate run walks every module tree a dozen-plus times (one per rule
family) and every function subtree several more (dataflow fixpoints,
donation checks, the body walker). The trees are immutable for the
duration of a run, so the flattened node list is computed once per
root and shared — generator/deque overhead was the single largest
line item in the 30s pre-commit budget.

Cache entries hold a strong reference to the root node, so ``id``
reuse cannot alias a stale entry; ``run_lint`` clears the cache at the
top of each run to bound memory across repeated runs in one process.
Only cache roots that are re-walked (module trees, function defs) —
one-shot walks of small sub-expressions should keep calling
``ast.walk`` directly rather than paying a cache slot.
"""

from __future__ import annotations

import ast
from typing import Dict, Tuple

_CACHE: Dict[int, Tuple[ast.AST, Tuple[ast.AST, ...]]] = {}


def walk_nodes(root: ast.AST) -> Tuple[ast.AST, ...]:
    """``tuple(ast.walk(root))``, computed once per root per run."""
    ent = _CACHE.get(id(root))
    if ent is None or ent[0] is not root:
        ent = (root, tuple(ast.walk(root)))
        _CACHE[id(root)] = ent
    return ent[1]


def clear() -> None:
    _CACHE.clear()
