"""Process-global structured event ring.

Counters say HOW OFTEN something happened; this ring says WHAT — the
durable-tier corruption events, quarantine actions, and integrity
degradations carry a file path, an offset, and a reason that no metric
label set should hold (unbounded cardinality). The ring is bounded,
lock-guarded, and surfaced at ``/debug/events`` (newest first), so an
operator chasing a ``filodb_storage_corruption_total`` bump lands on
the exact byte range and file within one request.

The rules engine keeps its own alert-transition ring (rules/engine.py)
— that one is per-engine protocol state; this one is the
process-global operational journal."""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional



class EventRing:
    """Bounded ring of structured events (dicts), newest kept."""

    def __init__(self, capacity: int = 512):
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=int(capacity))
        self._seq = 0

    def emit(self, kind: str, **fields) -> Dict:
        ev = {"kind": str(kind), "time": time.time(), **fields}
        with self._lock:
            self._seq += 1
            ev["seq"] = self._seq
            self._ring.append(ev)
        return ev

    def snapshot(self, limit: int = 100, kind: Optional[str] = None
                 ) -> List[Dict]:
        """Newest-first snapshot, optionally filtered by kind."""
        with self._lock:
            evs = list(self._ring)
        evs.reverse()
        if kind is not None:
            evs = [e for e in evs if e.get("kind") == kind]
        return evs[:max(0, int(limit))]

    def count(self, kind: Optional[str] = None) -> int:
        with self._lock:
            evs = list(self._ring)
        if kind is None:
            return len(evs)
        return sum(1 for e in evs if e.get("kind") == kind)

    def clear(self) -> None:
        """Test hook."""
        with self._lock:
            self._ring.clear()


GLOBAL_EVENTS = EventRing()


def emit(kind: str, **fields) -> Dict:
    """Emit one event onto the process-global ring."""
    return GLOBAL_EVENTS.emit(kind, **fields)


def snapshot(limit: int = 100, kind: Optional[str] = None) -> List[Dict]:
    return GLOBAL_EVENTS.snapshot(limit=limit, kind=kind)
