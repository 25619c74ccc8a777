"""Per-shard ingestion driver: checkpoint recovery then steady-state
ingest with interleaved group flushes.

(Reference: coordinator/IngestionActor.scala — ``startIngestion`` :174
reads the checkpoint watermark, ``doRecovery`` :297 replays the stream
from it publishing RecoveryInProgress events, ``normalIngestion`` :240
drives TimeSeriesShard.startIngestion; flush tasks are interleaved with
ingest on the shard's single ingest thread, TimeSeriesShard.scala:897.)

The port keeps the same protocol minus the actor machinery: one
Python thread per shard runs

    bootstrap (index + checkpoints from the ColumnStore, done by caller)
      -> recovery: replay stream from min(checkpoints) to the stream end
         observed at startup, shard status RECOVERY(progress%)
         (rows already flushed are dropped by the partitions' OOO guard)
      -> steady state: poll the stream; every ``flush_every_records``
         offsets (or ``flush_interval_s`` wall clock) flush the next
         flush group round-robin, checkpointing the last ingested offset.

Flush rotation mirrors the reference's groups-per-shard scheduling
(doc/ingestion.md "Recovery and Persistence"): each group checkpoint =
"all my partitions' rows at/below this offset are encoded+persisted", so
the replay watermark is min over groups.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, List, Optional

from filodb_tpu_torch.core.memstore import TimeSeriesShard
from filodb_tpu_torch.ingest import health as ingest_health
from filodb_tpu_torch.ingest.stream import IngestionStream
from filodb_tpu_torch.lint.threads import thread_root
from filodb_tpu_torch.obs import metrics as obs_metrics
from filodb_tpu_torch.parallel.shardmapper import ShardMapper, ShardStatus
from filodb_tpu_torch.testing import chaos

_FLUSH_HELP = ("Wall seconds per flush-group persist (encode + "
               "ColumnStore write + checkpoint)")


class IngestionDriver:
    """Drives one shard from one stream (IngestionActor + shard thread)."""

    def __init__(self, shard: TimeSeriesShard, stream: IngestionStream,
                 mapper: Optional[ShardMapper] = None,
                 flush_every_records: Optional[int] = None,
                 flush_interval_s: float = 1.0,
                 poll_interval_s: float = 0.02,
                 on_event: Optional[Callable] = None,
                 max_resident_samples: int = 0,
                 ingest_batch_records: int = 64,
                 max_decode_cache_bytes: int = 0,
                 max_quarantined_records: int = 0):
        self.shard = shard
        self.stream = stream
        self.mapper = mapper
        self.flush_every_records = flush_every_records
        self.flush_interval_s = flush_interval_s
        self.poll_interval_s = poll_interval_s
        self.on_event = on_event or (lambda *a: None)
        # memory-pressure watermark (0 = no cap): checked after flushes
        self.max_resident_samples = max_resident_samples
        # WAL read batch per poll (ingest-batch-records): bigger batches
        # amortize per-poll overhead during replay at the cost of
        # coarser flush-cadence checks between records
        self.ingest_batch_records = max(1, int(ingest_batch_records))
        # decode/merge-cache byte budget (0 = unbounded): trimmed on the
        # flush path via TimeSeriesShard.trim_decode_caches
        self.max_decode_cache_bytes = int(max_decode_cache_bytes)
        # integrity knob (integrity-max-quarantined-records): tolerated
        # quarantined-record loss before the shard degrades to
        # read-only. 0 = any quarantined record trips it.
        self.max_quarantined_records = int(max_quarantined_records)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._next_group = 0
        self._last_flush_t = 0.0
        self._records_since_flush = 0
        self.next_offset = 0          # next stream offset to ingest
        self.recovered_to = -1        # end of the recovery replay window

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "IngestionDriver":
        self._thread = threading.Thread(
            target=self._run, name=f"ingest-shard-{self.shard.shard_num}",
            daemon=True)
        self._thread.start()
        return self

    def stop(self, flush: bool = True, timeout: float = 10.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
        if flush and self.next_offset > 0:
            # final flush of all groups at the last ingested offset, so a
            # clean shutdown restarts with an up-to-date watermark
            self.shard.flush_all(offset=self.next_offset - 1)

    # -- protocol ----------------------------------------------------------
    def _set_status(self, status: ShardStatus, progress: int = 0) -> None:
        if self.mapper is not None:
            self.mapper.update(self.shard.shard_num, status,
                               progress_pct=progress)
        self.on_event(self.shard.shard_num, status, progress)

    @thread_root("ingest-shard")
    def _run(self) -> None:
        try:
            self._last_flush_t = time.monotonic()
            self._recover()
            self._set_status(ShardStatus.ACTIVE)
            self._last_flush_t = time.monotonic()
            while not self._stop.is_set():
                if not self._ingest_available():
                    self._maybe_flush(force_time_check=True)
                    self._stop.wait(self.poll_interval_s)
        except Exception:               # pragma: no cover - defensive
            self._set_status(ShardStatus.ERROR)
            raise

    def _recover(self) -> None:
        """Replay from the checkpoint watermark to the stream end observed
        at startup (IngestionActor.doRecovery :297).  The OOO guard drops
        rows at/below each partition's persisted end time, so replaying
        below per-group checkpoints is idempotent."""
        watermark = self.shard.recovery_watermark()
        # groups that never flushed have no checkpoint -> replay everything
        start = watermark + 1 if watermark >= 0 else 0
        end = self.stream.end_offset()          # recovery target
        self.next_offset = start
        self.recovered_to = end
        if start >= end:
            return
        self._set_status(ShardStatus.RECOVERY, 0)
        while self.next_offset < end and not self._stop.is_set():
            if not self._ingest_available(
                    limit=min(self.ingest_batch_records,
                              end - self.next_offset),
                    recovering=True):
                break                            # stream shrank (shouldn't)
            done = self.next_offset - start
            pct = int(100 * done / max(1, end - start))
            self._set_status(ShardStatus.RECOVERY, min(pct, 99))

    def _ingest_available(self, limit: Optional[int] = None,
                          recovering: bool = False) -> bool:
        """Poll + ingest one batch; returns True if anything was read.

        ``recovering=True`` (the startup replay) applies batches even
        once the quarantine knob trips: every record the scan kept is
        checksum-verified acked data, and dropping it would turn one
        corrupt record into a whole-shard truncation. The read-only
        flag (and its metric/event) still raises immediately — it gates
        NEW post-recovery ingest only."""
        if self.shard.integrity_read_only and not recovering:
            return False
        if limit is None:
            limit = self.ingest_batch_records
        batch = self.stream.read(self.next_offset, max_records=limit)
        # the read may have quarantined corrupt records: refresh the
        # shard's integrity state BEFORE applying the batch, so nothing
        # new lands once loss exceeds the knob
        q = getattr(self.stream, "quarantined_records", None)
        if q is not None or self.shard.column_store is not None:
            # read-only keeps the mapper status ACTIVE: the shard still
            # SERVES queries (flagged in health + metrics + events), it
            # just stops applying new records
            if self.shard.update_integrity(q() if q is not None else 0,
                                           self.max_quarantined_records) \
                    and not recovering:
                return False
        if not batch:
            return False
        # chaos fault point: a failing stream consumer (the Kafka-poll
        # failure analogue) — the driver thread's defensive handler
        # flips the shard to ERROR, which tests assert on
        chaos.fire("ingest.batch", shard=self.shard.shard_num,
                   offset=self.next_offset)
        for sd in batch:
            self.shard.ingest(sd.container, sd.offset)
            self.next_offset = sd.offset + 1
            self._records_since_flush += 1
            self._maybe_flush()
        return True

    def _maybe_flush(self, force_time_check: bool = False) -> None:
        due = False
        if self.flush_every_records is not None:
            due = self._records_since_flush >= self.flush_every_records
        if not due:
            now = time.monotonic()
            if now - self._last_flush_t >= self.flush_interval_s:
                due = True
        if not due or self.next_offset == 0:
            return
        group = self._next_group
        self._next_group = (self._next_group + 1) % self.shard.num_groups
        # chaos fault point: a failing flush (ColumnStore write error)
        chaos.fire("ingest.flush", shard=self.shard.shard_num,
                   group=group)
        try:
            with obs_metrics.timed("filodb_flush_seconds", _FLUSH_HELP):
                self.shard.flush_group(group, offset=self.next_offset - 1)
        except OSError as e:
            if ingest_health.GLOBAL.note_write_error(
                    e, f"flush shard={self.shard.shard_num} group={group}"):
                # out-of-space: the flush retries on its normal cadence
                # (the batch stays resident; the checkpoint did not
                # advance) — NOT a driver-thread-killing error
                self._last_flush_t = time.monotonic()
                return
            raise
        ingest_health.GLOBAL.note_write_ok()
        if self.max_resident_samples:
            self.shard.ensure_headroom(self.max_resident_samples)
        if self.max_decode_cache_bytes:
            self.shard.trim_decode_caches(self.max_decode_cache_bytes)
        self._records_since_flush = 0
        self._last_flush_t = time.monotonic()


def start_ingestion(shards: List[TimeSeriesShard],
                    streams: List[IngestionStream],
                    mapper: Optional[ShardMapper] = None,
                    **kw) -> List[IngestionDriver]:
    """Start one driver per (shard, stream) pair."""
    drivers = [IngestionDriver(sh, st, mapper, **kw)
               for sh, st in zip(shards, streams)]
    for d in drivers:
        d.start()
    return drivers
