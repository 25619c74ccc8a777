"""Thread-entry-point annotations and the runtime thread inventory.

:func:`thread_root` marks a function as the entry point of a thread —
the target of a ``threading.Thread``, an executor loop, or a periodic
daemon. graftlint's interprocedural engine (``lint/callgraph.py``)
discovers ``Thread(target=...)`` / ``.submit(fn)`` spawn sites on its
own; the explicit marker exists for three reasons:

  * entry points the AST cannot see (stdlib ``ThreadingHTTPServer``
    spawning per-connection handler threads, callbacks invoked by a
    foreign framework);
  * the **unguarded-shared-state** rule's root set: state compound-
    mutated from two or more roots with no common lock and no
    ``@guarded_by`` declaration is a finding;
  * the runtime inventory behind ``GET /debug/threads``: every marked
    root is listed with its module, qualname, and the ``@guarded_by``
    summary of its class, joined against ``threading.enumerate()``.

Usage (bare or named)::

    @thread_root                     # name defaults to the qualname
    def _run(self): ...

    @thread_root("failure-detector")
    def _run(self): ...

Modules that cannot import the decorator declare
``__thread_roots__ = ("fn_name", ...)`` instead (same AST semantics,
no runtime inventory entry).

The decorator is runtime-neutral: it records the function in
``THREAD_ROOTS`` and returns it unchanged.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Union

# qualname -> {"name": display name, "module": module, "qualname": ...}
THREAD_ROOTS: Dict[str, Dict[str, str]] = {}


def thread_root(arg: Union[Callable, str, None] = None):
    """Mark a function as a thread entry point (see module docstring).

    Works bare (``@thread_root``) or with a display name
    (``@thread_root("failure-detector")``)."""
    def _register(fn: Callable, name: Optional[str]) -> Callable:
        qual = getattr(fn, "__qualname__", getattr(fn, "__name__",
                                                   str(fn)))
        THREAD_ROOTS[qual] = {
            "name": name or qual,
            "module": getattr(fn, "__module__", "?"),
            "qualname": qual,
        }
        fn.__thread_root__ = name or qual
        return fn

    if callable(arg):
        return _register(arg, None)
    return lambda fn: _register(fn, arg)


def _guard_summary(module: str, qualname: str) -> Dict[str, str]:
    """The ``@guarded_by`` table of the root's class, resolved from the
    live module (best effort — {} when the class has no declarations or
    the module isn't imported)."""
    import sys
    mod = sys.modules.get(module)
    if mod is None or "." not in qualname:
        return {}
    cls_name = qualname.split(".")[0]
    cls = getattr(mod, cls_name, None)
    table = getattr(cls, "__guarded_by__", None)
    return dict(table) if isinstance(table, dict) else {}


def thread_inventory() -> List[Dict[str, object]]:
    """The ``/debug/threads`` payload: every registered root with its
    guard summary, plus which live threads currently run (matched by
    thread name against the root's display name / function name)."""
    live = {t.name: {"ident": t.ident, "daemon": t.daemon,
                     "alive": t.is_alive()}
            for t in threading.enumerate()}
    out: List[Dict[str, object]] = []
    for qual, info in sorted(THREAD_ROOTS.items()):
        fn_leaf = qual.rsplit(".", 1)[-1]
        matches = [dict(name=n, **v) for n, v in live.items()
                   if info["name"] in n or fn_leaf in n
                   or n.startswith(info["name"].split("-")[0])]
        out.append({
            "name": info["name"],
            "root": f"{info['module']}.{qual}",
            "guards": _guard_summary(info["module"], qual),
            "live_threads": matches,
        })
    return out
