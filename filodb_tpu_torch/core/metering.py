"""Per-tenant cardinality metering publisher.

The reference runs TenantIngestionMetering
(coordinator/src/main/scala/filodb.coordinator/TenantIngestionMetering.scala):
a periodic task issuing TsCardinalities against every dataset and
publishing the per-(_ws_, _ns_) series counts as metrics, so operators
chart tenant growth without querying the cardinality API. Same shape
here: a daemon thread snapshots the shard cardinality trackers at a
fixed interval into gauges the /metrics exposition serves."""

from __future__ import annotations

import threading
import time
from typing import Dict, Mapping, Optional, Tuple


class TenantMetering:
    """Periodic depth-2 (workspace, namespace) cardinality snapshots.

    Daemon-thread lifecycle contract (the reference's
    TenantIngestionMetering runs on the coordinator scheduler and dies
    with it): ``start()`` takes an eager first snapshot and spawns the
    loop; ``stop()`` is idempotent, joins the thread, and after it
    returns ``alive`` is False — the standalone server calls it on
    shutdown so no metering thread outlives the process teardown.
    ``last_snapshot_age_s`` is exported in /metrics so a stalled or
    dead loop shows as a growing age instead of silently-stale
    gauges."""

    def __init__(self, trackers: Mapping[int, object],
                 interval_s: float = 60.0, depth: int = 2):
        self.trackers = trackers          # shard -> CardinalityTracker
        self.interval_s = float(interval_s)
        self.depth = depth
        # (ws, ns) -> (ts_count, active_ts_count); swapped atomically
        self.latest: Dict[Tuple[str, ...], Tuple[int, int]] = {}
        self.snapshots = 0
        self.last_snapshot_t: Optional[float] = None   # monotonic
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    @property
    def alive(self) -> bool:
        """True while the snapshot thread is running (False before
        start and after a completed stop/join)."""
        return self._thread is not None and self._thread.is_alive()

    @property
    def last_snapshot_age_s(self) -> Optional[float]:
        """Seconds since the last completed snapshot (None before the
        first one) — the loop-liveness gauge."""
        if self.last_snapshot_t is None:
            return None
        return time.monotonic() - self.last_snapshot_t

    def count_for(self, prefix: Tuple[str, ...]) -> Optional[int]:
        """Series count for a (ws[, ns]) prefix from the latest
        snapshot, or None when the prefix has never appeared. The QoS
        cost estimator reads this to price REMOTE shard groups (local
        cardinality trackers only know local shards; the metering
        snapshot is the node's aggregated per-tenant view)."""
        latest = self.latest                    # atomic snapshot ref
        if not latest:
            return None
        total = 0
        found = False
        for pfx, (t, _a) in latest.items():
            if pfx[:len(prefix)] == tuple(prefix):
                total += t
                found = True
        return total if found else None

    def snapshot_once(self) -> None:
        agg: Dict[Tuple[str, ...], Tuple[int, int]] = {}
        for tracker in list(self.trackers.values()):
            for rec in tracker.scan((), self.depth):
                if len(rec.prefix) != self.depth:
                    continue
                t, a = agg.get(rec.prefix, (0, 0))
                agg[rec.prefix] = (t + rec.ts_count,
                                   a + rec.active_ts_count)
        self.latest = agg                 # atomic rebind for readers
        self.snapshots += 1
        self.last_snapshot_t = time.monotonic()

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.snapshot_once()
            except Exception:
                pass                      # keep the metering loop alive

    def start(self) -> "TenantMetering":
        self.snapshot_once()
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="tenant-metering")
        self._thread.start()
        return self

    def stop(self, timeout: float = 5.0) -> None:
        """Stop + JOIN the snapshot thread (idempotent; safe to call
        before start)."""
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=timeout)
            if not t.is_alive():
                self._thread = None
