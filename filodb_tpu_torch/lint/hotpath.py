"""Hot-path annotations for the ``host-transfer-in-hot-loop`` rule.

:func:`hot_path` marks a function as part of the per-query serving
fast path. Inside marked functions (and their lexically nested
helpers) graftlint flags device→host transfers and host syncs —
``.item()`` / ``.cpu()`` / ``.tolist()`` / ``.to("cpu")`` /
``np.asarray`` / ``torch.cuda.synchronize()`` — because an implicit sync
on a CUDA tensor stalls the async launch queue and holds the GIL through
device compute.
A *deliberate* sync point (e.g. the one amortized per-batch conversion
in ``SplitResult.get``) carries a
``# graftlint: disable=host-transfer-in-hot-loop (reason)`` pragma.

The decorator is runtime-neutral: it only records the function in
``HOT_PATHS`` (qualname registry, useful for docs/tests) and returns
it unchanged. Modules can alternatively declare
``__hot_path__ = ("fn_name", ...)`` for functions they cannot
decorate.
"""

from __future__ import annotations

from typing import Callable, List

HOT_PATHS: List[str] = []


def hot_path(fn: Callable) -> Callable:
    """Mark ``fn`` as per-query hot-path code (see module docstring)."""
    HOT_PATHS.append(getattr(fn, "__qualname__", getattr(fn, "__name__",
                                                         str(fn))))
    return fn
