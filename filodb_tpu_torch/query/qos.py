"""Priority classes and the per-query QoS context the micro-batcher reads
(the part of ``filodb_tpu.query.qos`` the serving fast path needs).

* **Priority classes** — interactive (0) > rules/background (1) >
  over-budget best-effort (2). The device executor orders its dispatch
  queue by class, so a tile rebuild or a best-effort scan never
  head-of-line blocks an interactive query.
* **QosContext** — the active class rides a thread-local, installed by
  :func:`activate` around a query and read by :func:`current_priority`.

Token buckets, admission control and plan cost estimates belong to the
HTTP edge and are not ported yet.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Optional

DEFAULT_TENANT = "default"

# priority classes, lower = sooner
PRIORITY_INTERACTIVE = 0
PRIORITY_BACKGROUND = 1
PRIORITY_BEST_EFFORT = 2
PRIORITY_NAMES = {PRIORITY_INTERACTIVE: "interactive",
                  PRIORITY_BACKGROUND: "background",
                  PRIORITY_BEST_EFFORT: "best_effort"}
_PRIORITY_BY_NAME = {
    "interactive": PRIORITY_INTERACTIVE,
    "background": PRIORITY_BACKGROUND,
    "rules": PRIORITY_BACKGROUND,
    "best_effort": PRIORITY_BEST_EFFORT,
    "best-effort": PRIORITY_BEST_EFFORT,
}


def parse_priority(raw: Optional[str]) -> int:
    """Priority class from a header/param value; unknown/absent values
    are interactive (never reject a query over a bad priority hint)."""
    if not raw:
        return PRIORITY_INTERACTIVE
    return _PRIORITY_BY_NAME.get(str(raw).strip().lower(),
                                 PRIORITY_INTERACTIVE)


@dataclass
class QosContext:
    """Per-query QoS state riding a thread-local."""
    tenant: str = DEFAULT_TENANT
    priority: int = PRIORITY_INTERACTIVE
    # the query entered the degrade ladder and runs best-effort
    degraded: bool = False
    # a fan-out leg: the entry node already admitted the query
    forced: bool = False


_state = threading.local()


def current() -> Optional[QosContext]:
    """The thread's active QoS context (None outside a query)."""
    return getattr(_state, "ctx", None)


def current_priority() -> int:
    ctx = current()
    return ctx.priority if ctx is not None else PRIORITY_INTERACTIVE


def capture() -> Optional[QosContext]:
    """Snapshot for cross-thread hops (re-installed with :func:`activate`)."""
    return current()


@contextmanager
def activate(ctx: Optional[QosContext]):
    """Install ``ctx`` as the thread's QoS context for the duration."""
    prev = getattr(_state, "ctx", None)
    _state.ctx = ctx
    try:
        yield ctx
    finally:
        _state.ctx = prev

