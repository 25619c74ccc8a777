"""Ingestion streams: pull-based, offset-carrying sample sources.

The reference's ingestion source boundary is IngestionStream
(coordinator/IngestionStream.scala:14,43) with the production impl bound
1 shard <-> 1 Kafka partition (kafka/KafkaIngestionStream.scala:26; ``get``
:81 returns an Observable[SomeData(RecordContainer, offset)] seeked to the
recovery offset).  Here the same contract is a poll API over monotonic
record ordinals:

  * ``SomeData`` = one RecordContainer + the offset it was published at.
  * ``IngestionStream.read(from_offset, max_records)`` returns whatever is
    available (possibly empty) — the ingestion driver polls it, exactly
    like a Kafka consumer poll loop.
  * ``LogIngestionStream`` is the durable Kafka-partition equivalent: an
    append-only framed file per shard.  The gateway (producer side) appends
    containers; the server (consumer side) tails the file across process
    boundaries, so a killed server replays from its checkpoint watermark.
  * ``MemoryIngestionStream`` is the in-process test stream (the
    reference's sources/CsvStream analogue).

Readers never truncate: a torn tail may be a writer mid-append (the two
sides are different processes); the reader simply waits for the record to
complete.
"""

from __future__ import annotations

import os
import struct
import threading
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from filodb_tpu_torch.core.record import PartKey, RecordContainer
from filodb_tpu_torch.core.schemas import ColumnType, Schemas
from filodb_tpu_torch.memory.histogram import _decode_scheme, _encode_scheme
from filodb_tpu_torch.obs import metrics as obs_metrics
from filodb_tpu_torch.store import integrity
from filodb_tpu_torch.testing import chaos

_APPEND_HELP = ("Wall seconds per durable-stream append (encode + "
                "write + flush + any fsync this append performed)")
_FSYNC_HELP = ("Wall seconds per durable-stream os.fsync (group commit "
               "coalesces appends: fsync count / append count is the "
               "coalescing ratio)")

_REC_MAGIC = 0xF10D
# record header: magic u16, schema_name_len u16, nrows u32, payload_len u32
_REC_HDR = struct.Struct("<HHII")


@dataclass(frozen=True)
class SomeData:
    """One published batch (IngestionStream.scala SomeData)."""
    container: RecordContainer
    offset: int


class IngestionStream:
    """Source abstraction (IngestionStream.scala:14): a sequence of
    RecordContainers with monotonically increasing offsets."""

    def read(self, from_offset: int, max_records: int = 64
             ) -> List[SomeData]:
        """Poll: return up to ``max_records`` batches at/after
        ``from_offset`` that are available now (may be empty)."""
        raise NotImplementedError

    def end_offset(self) -> int:
        """Offset one past the last published record (Kafka endOffset)."""
        raise NotImplementedError

    def close(self) -> None:
        pass


class MemoryIngestionStream(IngestionStream):
    """In-process stream for tests and embedded producers."""

    def __init__(self):
        self._records: List[RecordContainer] = []
        self._lock = threading.Lock()

    def append(self, container: RecordContainer) -> int:
        with self._lock:
            self._records.append(container)
            return len(self._records) - 1

    def read(self, from_offset: int, max_records: int = 64
             ) -> List[SomeData]:
        with self._lock:
            hi = min(len(self._records), from_offset + max_records)
            return [SomeData(self._records[i], i)
                    for i in range(max(0, from_offset), hi)]

    def end_offset(self) -> int:
        with self._lock:
            return len(self._records)


# ---------------------------------------------------------------------------
# Container wire format (the RecordContainer serde — the Kafka payload
# analogue, kafka/RecordContainerSerde)
# ---------------------------------------------------------------------------

def _encode_values(schema, columns: Sequence[Sequence], row: int) -> bytes:
    out = bytearray()
    for col, colvals in zip(schema.data_columns, columns):
        v = colvals[row]
        if col.col_type == ColumnType.HISTOGRAM:
            scheme, counts = v
            counts = np.asarray(counts, dtype="<f8")
            sb = _encode_scheme(scheme)
            out.extend(struct.pack("<HH", len(sb), counts.size))
            out.extend(sb)
            out.extend(counts.tobytes())
        else:
            out.extend(struct.pack("<d", float(v)))
    return bytes(out)


def _decode_values(schema, buf: bytes, off: int) -> Tuple[Tuple, int]:
    vals = []
    for col in schema.data_columns:
        if col.col_type == ColumnType.HISTOGRAM:
            sb_len, n = struct.unpack_from("<HH", buf, off)
            off += 4
            scheme, _ = _decode_scheme(buf, off)
            off += sb_len
            counts = np.frombuffer(buf, dtype="<f8", count=n, offset=off)
            off += 8 * n
            vals.append((scheme, counts))
        else:
            (v,) = struct.unpack_from("<d", buf, off)
            off += 8
            vals.append(v)
    return tuple(vals), off


def encode_container(container: RecordContainer) -> bytes:
    """Serialize one RecordContainer to a framed record."""
    schema = container.schema
    name = schema.name.encode()
    payload = bytearray()
    for i in range(len(container)):
        pk = container.part_keys[i].to_bytes()
        payload.extend(struct.pack("<H", len(pk)))
        payload.extend(pk)
        payload.extend(struct.pack("<q", container.timestamps[i]))
        payload.extend(_encode_values(schema, container.columns, i))
    return (_REC_HDR.pack(_REC_MAGIC, len(name), len(container),
                          len(payload)) + name + bytes(payload))


def decode_container(buf: bytes, off: int, schemas: Schemas
                     ) -> Tuple[Optional[RecordContainer], int]:
    """Decode one framed record at ``off``; returns (container, next_off)
    or (None, off) when the record is incomplete (torn / mid-write)."""
    if off + _REC_HDR.size > len(buf):
        return None, off
    magic, name_len, nrows, payload_len = _REC_HDR.unpack_from(buf, off)
    if magic != _REC_MAGIC:
        raise ValueError(f"bad stream record magic at {off}")
    end = off + _REC_HDR.size + name_len + payload_len
    if end > len(buf):
        return None, off
    p = off + _REC_HDR.size
    name = buf[p:p + name_len].decode()
    p += name_len
    schema = schemas.by_name(name)
    cont = RecordContainer(schema)
    for _ in range(nrows):
        (pk_len,) = struct.unpack_from("<H", buf, p)
        p += 2
        pk = PartKey.from_bytes(buf[p:p + pk_len])
        p += pk_len
        (ts,) = struct.unpack_from("<q", buf, p)
        p += 8
        vals, p = _decode_values(schema, buf, p)
        cont.add(pk, ts, *vals)
    return cont, end


def legacy_wal_probe(buf: bytes, off: int) -> int:
    """Integrity-scanner probe for pre-framing WAL records: total
    record length when a plausible legacy record starts at ``off``,
    -1 when one starts but runs past the buffer (torn), 0 otherwise."""
    if off + _REC_HDR.size > len(buf):
        return -1 if off + 2 <= len(buf) and \
            struct.unpack_from("<H", buf, off)[0] == _REC_MAGIC else 0
    magic, name_len, _, payload_len = _REC_HDR.unpack_from(buf, off)
    if magic != _REC_MAGIC:
        return 0
    if payload_len > integrity.MAX_PAYLOAD:
        return 0
    total = _REC_HDR.size + name_len + payload_len
    return total if off + total <= len(buf) else -1


# producer and consumer sides may be different THREADS in one process
# (embedded gateway + ingest driver): the writer handle, the record
# index, and the scan watermark all ride one lock
class LogIngestionStream(IngestionStream):
    """Durable file-backed stream: one append-only framed log per shard —
    the Kafka-partition analogue (1 shard <-> 1 log, KafkaIngestionStream).

    Producer side uses ``append``; consumer side polls ``read``.  The two
    may be different processes: the reader tails the file, stopping at any
    incomplete tail record until the writer finishes it.

    Group-commit fsync: per-append ``os.fsync`` was the residual
    episodic stall on shared container disks (ROADMAP follow-up — one
    slow fsync froze the ingest thread mid-batch). With
    ``group_commit_s > 0`` appends write+flush but fsync only when the
    time window elapses or ``group_commit_bytes`` accumulate unsynced —
    the Kafka ``log.flush.interval`` shape. The durability window is
    bounded by exactly those two knobs; ``sync()`` forces, ``close()``
    syncs the tail. ``group_commit_s = 0`` (the default) keeps the
    strict fsync-per-append behavior. Every real fsync observes
    ``filodb_ingest_fsync_seconds`` so the stall the ROADMAP saw is
    visible data, not a guess."""

    def __init__(self, path: str, schemas: Schemas,
                 group_commit_s: float = 0.0,
                 group_commit_bytes: int = 1 << 20,
                 integrity_frames: bool = True):
        self.path = path
        self.schemas = schemas
        self.group_commit_s = float(group_commit_s)
        self.group_commit_bytes = int(group_commit_bytes)
        # integrity_frames=False writes legacy unframed records — kept
        # for mixed-version tests and the bench's CRC on/off split
        self.integrity_frames = bool(integrity_frames)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._write_f = None
        self._lock = threading.Lock()
        # reader state: scanner-verified records, the classified-bytes
        # watermark the next scan resumes from, and the last tail state
        self._records: List[integrity.ScanRecord] = []
        self._scan_end = 0
        self._tail_state = "clean"
        self._tail_off = 0
        self._tail_reason = ""
        self._tail_reported_off = -1
        # read-time verification strikes per ordinal: first failure
        # retries from disk (transient), second skips-and-advances
        self._read_bad: Dict[int, int] = {}
        self._quarantined_records = 0
        self._quarantined_bytes = 0
        # group-commit state: when the last fsync happened and how many
        # bytes are flushed-but-unsynced since
        self._last_sync_t = 0.0
        self._unsynced_bytes = 0
        self.appends = 0
        self.fsyncs = 0

    # -- producer side ----------------------------------------------------
    def append(self, container: RecordContainer, fsync: bool = True) -> int:
        """Publish one container; returns its offset (ordinal).  One writer
        per shard log (the shard<->partition ownership invariant); on
        takeover, a torn tail left by a crashed writer is truncated so the
        new append lands on a record boundary (a CORRUPT tail — bad bytes,
        not just incomplete — is quarantined before the truncate)."""
        import time as _time
        t0 = _time.perf_counter()
        payload = encode_container(container)
        data = integrity.encode_frame(payload) if self.integrity_frames \
            else payload
        with self._lock:
            if self._write_f is None:
                self._refresh_locked()
                if os.path.exists(self.path) and \
                        os.path.getsize(self.path) > self._scan_end:
                    if self._tail_state == "corrupt":
                        self._quarantine_tail_locked()
                    os.truncate(self.path, self._scan_end)
                    self._tail_state = "clean"
                self._write_f = open(self.path, "ab")
            off = len(self._records)
            try:
                chaos.write("wal.append", self._write_f, data,
                            path=self.path, nbytes=len(data))
                self._write_f.flush()
            except OSError:
                # the buffer may hold a torn prefix: flush it out and
                # drop the handle so the next append takes over (and
                # truncates the torn tail) instead of appending after it
                try:
                    self._write_f.close()
                except OSError:
                    pass
                self._write_f = None
                raise
            self._unsynced_bytes += len(data)
            if fsync:
                # graftlint: disable=lock-blocking-reachable (single-writer WAL: the lock IS the producer/consumer serialization; group commit bounds the fsync window)
                self._maybe_fsync_locked()
            hdr = integrity.FRAME_HDR.size if self.integrity_frames else 0
            self._records.append(integrity.ScanRecord(
                self._scan_end, len(data), self._scan_end + hdr,
                len(payload), self.integrity_frames))
            self._scan_end += len(data)
            self.appends += 1
        obs_metrics.observe("filodb_ingest_append_seconds", _APPEND_HELP,
                            _time.perf_counter() - t0,
                            obs_metrics.FSYNC_BUCKETS_S)
        return off

    def _maybe_fsync_locked(self, force: bool = False) -> None:
        """Group commit: fsync now when forced, when group commit is
        off, or when the time/size bound tripped; otherwise leave the
        bytes flushed-but-unsynced (the bounded durability window)."""
        import time as _time
        if self._unsynced_bytes == 0:
            return
        now = _time.monotonic()
        if not force and self.group_commit_s > 0:
            if (now - self._last_sync_t < self.group_commit_s
                    and self._unsynced_bytes < self.group_commit_bytes):
                return
        t0 = _time.perf_counter()
        chaos.fire("wal.fsync", path=self.path)
        os.fsync(self._write_f.fileno())
        obs_metrics.observe("filodb_ingest_fsync_seconds", _FSYNC_HELP,
                            _time.perf_counter() - t0,
                            obs_metrics.FSYNC_BUCKETS_S)
        self.fsyncs += 1
        self._last_sync_t = now
        self._unsynced_bytes = 0

    def sync(self) -> None:
        """Force-fsync any unsynced tail (checkpoint barriers)."""
        with self._lock:
            if self._write_f is not None:
                # graftlint: disable=lock-blocking-reachable (checkpoint barrier: readers must not observe the log mid-sync)
                self._maybe_fsync_locked(force=True)

    # -- consumer side ----------------------------------------------------
    def _refresh_locked(self) -> int:
        """Extend the record index over newly appended bytes via the
        integrity scanner; returns the current record count. Corrupt
        regions are quarantined and SKIPPED (replay resumes at the next
        verified boundary) — the pre-integrity behavior of silently
        halting indexing forever is gone."""
        if not os.path.exists(self.path):
            return 0
        size = os.path.getsize(self.path)
        if size <= self._scan_end:
            return len(self._records)
        with open(self.path, "rb") as f:
            f.seek(self._scan_end)
            buf = f.read(size - self._scan_end)
        buf = chaos.filter_read("wal.read", buf, path=self.path,
                                offset=self._scan_end)
        res = integrity.scan_buffer(buf, probe=legacy_wal_probe,
                                    base=self._scan_end)
        for reg in res.corrupt:
            integrity.quarantine(
                self.path, "wal", reg.offset,
                buf[reg.offset - self._scan_end:
                    reg.offset - self._scan_end + reg.length],
                reg.reason)
            self._quarantined_records += 1
            self._quarantined_bytes += reg.length
        self._records.extend(res.records)
        self._scan_end += res.consumed
        self._tail_state = res.tail_state
        self._tail_off = res.tail_off
        self._tail_reason = res.tail_reason
        if (res.tail_state == "corrupt"
                and res.tail_off != self._tail_reported_off):
            # bad bytes with no resync point yet: more appends may
            # reveal one (then the region quarantines above), takeover
            # quarantines + truncates, fsck repairs — but say so NOW
            self._tail_reported_off = res.tail_off
            integrity.record_corruption(
                "wal", self.path, res.tail_off,
                size - res.tail_off, res.tail_reason, action="pending")
        return len(self._records)

    def _quarantine_tail_locked(self) -> None:
        """Copy a corrupt tail to the sidecar before takeover truncates
        it (truncation must never destroy the only copy of bad bytes)."""
        try:
            with open(self.path, "rb") as f:
                f.seek(self._scan_end)
                tail = f.read()
        except OSError:
            return
        if tail:
            integrity.quarantine(self.path, "wal", self._scan_end, tail,
                                 self._tail_reason or "corrupt tail",
                                 action="quarantined-truncated")
            self._quarantined_records += 1
            self._quarantined_bytes += len(tail)

    def _empty_container(self) -> RecordContainer:
        """Zero-row placeholder emitted for a record whose bytes failed
        read-time verification twice: replay ADVANCES past the damage
        (the bytes are already quarantined) instead of stalling."""
        schema = next(iter(self.schemas.schemas.values()))
        return RecordContainer(schema)

    def read(self, from_offset: int, max_records: int = 64
             ) -> List[SomeData]:
        with self._lock:
            n = self._refresh_locked()
            lo = max(0, from_offset)
            hi = min(n, lo + max_records)
            if lo >= hi:
                return []
            records = self._records[lo:hi]
        base = records[0].offset
        end = records[-1].offset + records[-1].length
        with open(self.path, "rb") as f:
            f.seek(base)
            buf = f.read(end - base)
        buf = chaos.filter_read("wal.read", buf, path=self.path,
                                offset=base)
        out: List[SomeData] = []
        for i, rec in enumerate(records):
            ordinal = lo + i
            try:
                if rec.framed:
                    # read-path verification: the CRC is re-checked on
                    # every decode, not only at scan time — bit rot
                    # between scan and read cannot reach a query
                    payload, _ = integrity.decode_frame(
                        buf, rec.offset - base)
                    if payload is None:
                        break              # torn at buffer end: wait
                    cont, _ = decode_container(payload, 0, self.schemas)
                else:
                    cont, _ = decode_container(buf, rec.offset - base,
                                               self.schemas)
                    if cont is None:
                        break
            except (integrity.FrameError, ValueError, KeyError,
                    struct.error) as e:
                with self._lock:
                    strikes = self._read_bad.get(ordinal, 0)
                    self._read_bad[ordinal] = strikes + 1
                if strikes == 0:
                    # first failure: stop here and let the next poll
                    # re-read from disk (a transient flip heals itself)
                    integrity.record_corruption(
                        "wal", self.path, rec.offset, rec.length,
                        f"read-time verification failed: {e}",
                        action="read-retry")
                    break
                # persistent damage: quarantine the bytes, emit an
                # empty batch at this ordinal so replay advances
                integrity.quarantine(
                    self.path, "wal", rec.offset,
                    buf[rec.offset - base:rec.offset - base + rec.length],
                    f"read-time verification failed: {e}",
                    action="skipped")
                with self._lock:
                    self._quarantined_records += 1
                    self._quarantined_bytes += rec.length
                cont = self._empty_container()
            out.append(SomeData(cont, ordinal))
        return out

    def end_offset(self) -> int:
        with self._lock:
            return self._refresh_locked()

    def quarantined_records(self) -> int:
        with self._lock:
            return self._quarantined_records

    def quarantined_bytes(self) -> int:
        with self._lock:
            return self._quarantined_bytes

    def tail_state(self) -> str:
        with self._lock:
            return self._tail_state

    def close(self) -> None:
        with self._lock:
            if self._write_f is not None:
                # sync the group-commit tail: a clean close must not
                # leave the durability window open
                # graftlint: disable=lock-blocking-reachable (close-time tail sync; no reader may race the handle teardown)
                self._maybe_fsync_locked(force=True)
                self._write_f.close()
                self._write_f = None
