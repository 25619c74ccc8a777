"""Plan cache: skip PromQL parse + logical-plan construction on repeat
queries.

Dashboards re-issue the SAME query text every refresh with a sliding
(start, end); today each hit replans from scratch. The cache keys on
(dataset, query text, step) with the evaluation range abstracted out of
the key: a hit stores the plan parsed at some canonical range and
REBASES it onto the request's range via
:func:`filodb_tpu_torch.query.engine.lp_replace_range` — the same rewrite the
raw/downsample tier split and subquery evaluation already rely on, so a
rebased plan is exactly what a fresh parse would have produced (the
plan-cache correctness tests pin this as a golden comparison).

Only rebasable shapes are cached: ``_splittable`` plans (the
lp_replace_range-rewritable closure — no @-pinned selectors, no
subqueries) that carry an evaluation grid (``plan_range`` is not None —
this excludes top-level raw exports, whose fetch bounds
lp_replace_range does not rewrite). Everything else parses fresh on
every request; ``uncacheable`` counts those.

Invalidation: parsing itself is topology- and schema-independent, but
cached plans must never outlive a world they were built against —
``invalidate()`` is the explicit hook. The HTTP server wires it to
shard-topology changes (ShardMapper events) and exposes it for schema
changes; both clear the cache and bump ``invalidations``.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Dict, Optional, Tuple



def _cacheable(plan) -> bool:
    from filodb_tpu_torch.query.planner import _splittable, plan_range
    return _splittable(plan) and plan_range(plan) is not None


def range_abstracted_key(dataset: str, query: str, step_ms: int) -> Tuple:
    """The shared range-abstracted cache key: (dataset, normalized query
    text, step). Both the plan cache and the results cache key on it —
    dashboards re-issue the SAME text with a sliding (start, end), so
    the range must stay out of the key (the results cache additionally
    sub-keys on step alignment, ``start % step``)."""
    return (dataset, query, int(step_ms))


# parsed plans are topology- and schema-dependent ONLY — the evaluation
# range is abstracted out of the key, so watermark/backfill events
# cannot affect an entry. Topology and schema changes reach `invalidate`
# (the ShardMapper subscription and the explicit schema hook).
class PlanCache:
    """LRU of parsed logical plans, keyed (dataset, query, step_ms)."""

    def __init__(self, capacity: int = 256):
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        # (dataset, query, step_ms) -> (plan, start_ms, end_ms)
        self._entries: "OrderedDict[Tuple, Tuple]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.uncacheable = 0
        self.invalidations = 0
        # observability: WHY the cache was cleared (topology vs schema
        # vs explicit) — a flapping mapper shows as topology churn here
        self.invalidations_by_reason: Dict[str, int] = {}
        self.rebases = 0
        # downstream caches keyed on the same world (the results cache)
        # ride this cache's invalidation events: any reason that clears
        # cached plans also clears cached results. Listeners are called
        # OUTSIDE the lock (they take their own).
        self._listeners: list = []

    @property
    def enabled(self) -> bool:
        return self.capacity > 0

    def lookup(self, dataset: str, query: str, start_ms: int,
               step_ms: int, end_ms: int):
        """Cached plan rebased onto [start, end], or None (parse fresh +
        ``store``). The cached canonical plan is never mutated —
        lp_replace_range builds a fresh dataclass tree."""
        if not self.enabled:
            return None
        key = (dataset, query, int(step_ms))
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                self.misses += 1
                return None
            self._entries.move_to_end(key)
            self.hits += 1
            plan, c_start, c_end = entry
        if c_start == start_ms and c_end == end_ms:
            return plan
        from filodb_tpu_torch.query.engine import lp_replace_range
        with self._lock:
            self.rebases += 1
        return lp_replace_range(plan, int(start_ms), int(step_ms),
                                int(end_ms))

    def store(self, dataset: str, query: str, start_ms: int,
              step_ms: int, end_ms: int, plan) -> None:
        if not self.enabled:
            return
        if not _cacheable(plan):
            with self._lock:
                self.uncacheable += 1
            return
        key = (dataset, query, int(step_ms))
        with self._lock:
            self._entries[key] = (plan, int(start_ms), int(end_ms))
            self._entries.move_to_end(key)
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)

    def add_invalidation_listener(self, fn) -> None:
        """Register ``fn(reason)`` to run after every invalidation —
        the hook the results cache uses to share this cache's topology/
        schema invalidation events."""
        self._listeners.append(fn)

    def invalidate(self, reason: str = "") -> None:
        """Explicit invalidation hook: shard-topology or schema change.
        Clears every cached plan and notifies listeners (result cache)."""
        with self._lock:
            self._entries.clear()
            self.invalidations += 1
            key = reason or "unspecified"
            self.invalidations_by_reason[key] = \
                self.invalidations_by_reason.get(key, 0) + 1
        for fn in list(self._listeners):
            fn(reason)

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return {"entries": len(self._entries), "hits": self.hits,
                    "misses": self.misses, "rebases": self.rebases,
                    "uncacheable": self.uncacheable,
                    "invalidations": self.invalidations,
                    "invalidations_by_reason":
                        dict(self.invalidations_by_reason)}
