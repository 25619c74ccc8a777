"""Slow-query log + in-flight query registry.

The operational complement to tracing: tracing samples, the slow-query
log CATCHES — every query whose total latency crosses the threshold
leaves a structured record (query text, dataset, shards touched,
per-stage breakdown, cache dispositions, partial/warning markers, and
the trace id when one was sampled), retrievable from a bounded ring at
``/debug/slow_queries`` and mirrored to the standard logger. The
in-flight registry behind ``/debug/queries`` answers the on-call
question "what is running RIGHT NOW and which stage is it stuck in"
(the reference's QueryActor mailbox visibility equivalent).
"""

from __future__ import annotations

import itertools
import logging
import threading
import time
from collections import deque
from typing import Dict, List, Optional


log = logging.getLogger("filodb.slowquery")


class SlowQueryLog:
    """Bounded ring of structured slow-query records.

    ``threshold_ms <= 0`` disables recording entirely (one float
    compare per query)."""

    def __init__(self, threshold_ms: float = 1000.0, capacity: int = 128):
        self.threshold_ms = float(threshold_ms)
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._records: deque = deque(maxlen=self.capacity)
        self.recorded = 0

    @property
    def enabled(self) -> bool:
        return self.threshold_ms > 0

    def maybe_record(self, elapsed_ms: float, record: Dict) -> bool:
        """Record when over threshold; ``record`` is the caller-built
        structured dict (the caller only builds it on the slow path)."""
        if self.threshold_ms <= 0 or elapsed_ms < self.threshold_ms:
            return False
        record = dict(record)
        record["elapsed_ms"] = round(float(elapsed_ms), 3)
        record["ts"] = time.time()
        with self._lock:
            self._records.append(record)
            self.recorded += 1
        try:
            log.warning("slow query (%.1fms > %.0fms): %s",
                        elapsed_ms, self.threshold_ms,
                        record.get("query", "?"))
        except Exception:
            pass
        return True

    def records(self, limit: int = 50) -> List[Dict]:
        with self._lock:
            out = list(self._records)
        return out[-max(1, int(limit)):][::-1]

    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            return {"threshold_ms": self.threshold_ms,
                    "recorded": self.recorded,
                    "stored": len(self._records)}


class InflightRegistry:
    """Currently-running queries and their elapsed stage.

    ``register`` returns a token the request path mutates through
    ``stage()`` (a plain dict write — readers tolerate racy snapshots,
    this is debug introspection, not accounting) and releases via
    ``unregister`` in a finally block."""

    def __init__(self):
        self._lock = threading.Lock()
        self._inflight: Dict[int, Dict] = {}
        self._ids = itertools.count(1)

    def register(self, query: str, dataset: str, **extra) -> Dict:
        qid = next(self._ids)
        entry = {"id": qid, "query": query, "dataset": dataset,
                 "t0": time.time(), "stage": "start", **extra}
        with self._lock:
            self._inflight[qid] = entry
        return entry

    @staticmethod
    def stage(entry: Optional[Dict], stage: str) -> None:
        if entry is not None:
            entry["stage"] = stage

    def unregister(self, entry: Optional[Dict]) -> None:
        if entry is None:
            return
        with self._lock:
            self._inflight.pop(entry["id"], None)

    def snapshot(self) -> List[Dict]:
        now = time.time()
        with self._lock:
            entries = [dict(e) for e in self._inflight.values()]
        out = []
        for e in sorted(entries, key=lambda e: e["t0"]):
            e["elapsed_ms"] = round((now - e.pop("t0")) * 1000, 3)
            out.append(e)
        return out

    def __len__(self) -> int:
        with self._lock:
            return len(self._inflight)
