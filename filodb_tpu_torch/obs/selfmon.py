"""Self-monitoring: the node ingests its own metrics as a first-class
tenant (the counterpart of ``filodb_tpu.obs.selfmon``).

FiloDB is a Prometheus-compatible TSDB whose canonical deployment
monitors itself with itself — yet our ``/metrics`` was exposition-only.
This module closes the loop: on ``--self-monitor``, a per-process
background loop periodically snapshots the whole metrics surface
**in-process** (no HTTP scrape: it asks the server for its
:class:`~filodb_tpu_torch.obs.metrics.ExpositionBuilder` and walks
``families()`` structurally), converts every counter/gauge/histogram
sample to ingest records via the normal
:class:`~filodb_tpu_torch.core.record.RecordBuilder`, and pushes them through
the NORMAL ingest path into a reserved internal dataset — WAL append,
ingestion-driver replay, memstore, flush, and (when configured)
downsampling all exercise it, and the series come back out through the
ordinary PromQL endpoints::

    /promql/__selfmon__/api/v1/query_range?query=
        rate(filodb_executable_recompiles_total[5m])

Design points:

* **Reserved tenant** — internal series are tagged
  ``_ws_ = "__selfmon__"``; queries under that tenant ride the
  background priority class and charge FORCED (like fan-out legs), so
  self-telemetry can neither crowd out user queries nor bounce off a
  drained admission bucket (standing rule evaluation must never
  starve — the write-back rail ROADMAP 2's recording rules ride).
* **Cardinality isolation** — the internal dataset gets its own
  shard(s) with their own :class:`CardinalityTracker`/``TagIndex``
  (both are per-shard by construction), so internal series never touch
  user-dataset cardinality accounting or quotas.
* **Freshness** — the internal shard is a normal shard: its ingest
  watermark advances with every flush, so the results cache's
  freshness horizon is sound for self-queries exactly as for user
  queries; the loop additionally surfaces its own watermark
  (last-tick age, samples/tick) as gauges — which it then ingests,
  naturally.
* **Fleet** — under the supervisor every worker runs its own loop over
  its own internal shard (shard number = worker ordinal, so shared
  data/stream dirs never collide) and stamps a ``worker`` label on
  every internal series; the supervisor's merged view preserves it
  (merge idempotence keeps an existing worker label).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional

from filodb_tpu_torch.lint.locks import guarded_by
from filodb_tpu_torch.lint.threads import thread_root
from filodb_tpu_torch.obs import metrics as obs_metrics
from filodb_tpu_torch.obs.writeback import IngestWriteBack, schema_for_sample

# reserved identifiers: the internal dataset name doubles as the
# reserved tenant (workspace) internal series are tagged with
SELFMON_DATASET = "__selfmon__"
SELFMON_TENANT = "__selfmon__"

_TICK_HELP = "Wall seconds per self-monitoring collect+ingest tick"


@guarded_by("_lock", "ticks", "samples_ingested", "series_last_tick",
            "errors", "last_tick_monotonic", "last_tick_s")
class SelfMonitor:
    """The per-process self-monitoring loop (a declared thread root).

    ``exposition_source()`` returns an ExpositionBuilder holding the
    full metrics surface (the HTTP server's ``build_exposition``);
    records flow to ``stream.append`` when a durable stream is wired
    (the ingestion driver then replays them — the full WAL path) or
    straight into ``shard.ingest`` + periodic flush otherwise."""

    def __init__(self, exposition_source, shard,
                 schemas=None, stream=None,
                 interval_s: float = 5.0,
                 node: str = "", worker_id: Optional[int] = None,
                 flush_every_ticks: int = 4):
        from filodb_tpu_torch.core.schemas import DEFAULT_SCHEMAS
        self.exposition_source = exposition_source
        self.shard = shard
        self.schemas = schemas or DEFAULT_SCHEMAS
        self.stream = stream
        # the factored write-back rail (obs/writeback.py): this loop is
        # its single writer; the rules engine drives its own instance
        self.writeback = IngestWriteBack(shard, schemas=self.schemas,
                                         stream=stream)
        self.interval_s = float(interval_s)
        self.node = node or ""
        self.worker_id = worker_id
        self.flush_every_ticks = max(1, int(flush_every_ticks))
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self.ticks = 0
        self.samples_ingested = 0
        self.series_last_tick = 0
        self.errors = 0
        self.last_tick_monotonic: Optional[float] = None
        self.last_tick_s = 0.0
        # the loop's own families ride the registry, so the NEXT tick
        # ingests this tick's health — the loop monitors itself too
        reg = obs_metrics.GLOBAL_REGISTRY
        self._m_ticks = reg.counter(
            "filodb_selfmon_ticks_total",
            "Self-monitoring collect+ingest ticks completed")
        self._m_samples = reg.counter(
            "filodb_selfmon_samples_ingested_total",
            "Metric samples self-ingested into the internal dataset")
        self._m_errors = reg.counter(
            "filodb_selfmon_errors_total",
            "Self-monitoring ticks that raised (collection continues)")
        self._m_series = reg.gauge(
            "filodb_selfmon_series_last_tick",
            "Distinct internal series written by the last tick")
        reg.register_collector(self._collect_age)

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "SelfMonitor":
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="selfmon-loop")
        self._thread.start()
        return self

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
        obs_metrics.GLOBAL_REGISTRY.unregister_collector(self._collect_age)

    @property
    def alive(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def _collect_age(self, builder) -> None:
        # sample straight into the CURRENT build (a gauge family set
        # here would only surface in the NEXT exposition — racy when a
        # scrape lands between the first completed tick and the next
        # build's collector phase)
        with self._lock:
            last = self.last_tick_monotonic
        if last is not None:
            builder.sample(
                "filodb_selfmon_last_tick_age_seconds", {},
                round(time.monotonic() - last, 3), mtype="gauge",
                help="Seconds since the last completed self-monitoring "
                     "tick (the loop's own freshness watermark)")

    @thread_root("selfmon-loop")
    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.collect_once()
            except Exception:   # noqa: BLE001 — telemetry must not die
                with self._lock:
                    self.errors += 1
                self._m_errors.inc()

    # -- one tick ----------------------------------------------------------
    def collect_once(self, now_ms: Optional[int] = None) -> int:
        """Snapshot the registry walk and ingest every sample; returns
        the number of samples written. Public for tests and for an
        eager first tick at startup."""
        t0 = time.perf_counter()
        if now_ms is None:
            now_ms = int(time.time() * 1000)
        builder = self.exposition_source()
        out = []
        series: set = set()
        for fam, mtype, _help, samples in builder.families():
            for name, labels_tuple, value in samples:
                try:
                    v = float(str(value).replace("+Inf", "inf")
                              .replace("NaN", "nan"))
                except (TypeError, ValueError):
                    continue
                labels: Dict[str, str] = {
                    "_ws_": SELFMON_TENANT,
                    "_ns_": self.node or "node",
                    "_metric_": name,
                }
                for k, lv in labels_tuple:
                    if k not in labels:
                        labels[k] = lv
                if self.worker_id is not None:
                    labels.setdefault("worker", str(self.worker_id))
                out.append((schema_for_sample(mtype, name), labels,
                            now_ms, v))
                series.add((name, labels_tuple))
        n = self.writeback.write(out)
        with self._lock:
            self.ticks += 1
            self.samples_ingested += n
            self.series_last_tick = len(series)
            self.last_tick_monotonic = time.monotonic()
            self.last_tick_s = time.perf_counter() - t0
            ticks = self.ticks
        if self.stream is None and ticks % self.flush_every_ticks == 0:
            # direct-ingest mode: flush so the ingest watermark (the
            # results cache's freshness input) advances like any shard
            self.writeback.flush()
        self._m_ticks.inc()
        self._m_samples.inc(n)
        self._m_series.set(len(series))
        obs_metrics.observe("filodb_selfmon_tick_seconds", _TICK_HELP,
                            time.perf_counter() - t0)
        return n

    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            return {"ticks": self.ticks,
                    "samples_ingested": self.samples_ingested,
                    "series_last_tick": self.series_last_tick,
                    "errors": self.errors,
                    "last_tick_s": round(self.last_tick_s, 6),
                    "interval_s": self.interval_s,
                    "alive": self.alive}
