"""ColumnStore: durable chunk + partkey + checkpoint persistence.

The pluggable boundary mirrors the reference's ChunkSink/RawChunkSource
(store/ChunkSink.scala; store/ChunkSource.scala:25) and the Cassandra
implementation's tables (cassandra/columnstore/CassandraColumnStore.scala:54:
TimeSeriesChunksTable, PartitionKeysTable; metastore CheckpointTable.scala:26)
— but the storage engine is host-native: encoded chunks are already
immutable compressed byte vectors (the interchange format), so persistence is
append-only framed logs per shard, fsync'd per flush group. No external
database is required; an object-store or Cassandra client can implement the
same four-method API.

Layout under root:
    <dataset>/shard=<n>/chunks.log      framed: partkey + chunk meta + vectors
    <dataset>/shard=<n>/partkeys.log    framed: partkey + startTime + endTime
    <dataset>/shard=<n>/checkpoints.json   CRC envelope over {group: offset}
    <dataset>/shard=<n>/quarantine/     sidecar: bad byte ranges + manifest

Integrity (the reference gets this from Cassandra; see store/integrity.py):
every record is wrapped in a checksummed frame on write, and every read —
index build, ODP chunk fetch, partkey scan, checkpoint load — verifies
before decoding. Corrupt records are quarantined and skipped (scan resumes
at the next verified boundary), torn tails are truncated at the writer's
takeover, and legacy unframed records read back unchanged via a per-record
magic sniff (compaction via delete_part_keys rewrites surviving records
framed, migrating the file). ENOSPC and friends propagate to the caller
(the ingestion driver maps them to the ingest-read-only degradation) with
the partial batch truncated away, so a failed write never leaves torn
bytes mid-log.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass
from typing import Dict, Iterator, List, Sequence, Set, Tuple

from filodb_tpu_torch.store import integrity
from filodb_tpu_torch.testing import chaos

_CHUNK_MAGIC = 0xC4A2
_PK_MAGIC = 0xBE11

# chunk record header: magic u16, pk_len u16, ncols u16, pad u16,
#                      chunk_id i64, num_rows i32, start i64, end i64
_CHUNK_HDR = struct.Struct("<HHHHqiqq")
# partkey record: magic u16, pk_len u16, start i64, end i64
_PK_HDR = struct.Struct("<HHqq")


@dataclass(frozen=True)
class PartKeyEntry:
    """One persisted partkey (PartitionKeysTable row)."""
    part_key: bytes
    start_ts: int
    end_ts: int


@dataclass(frozen=True)
class PersistedChunk:
    """One persisted chunk set (TimeSeriesChunksTable row)."""
    part_key: bytes
    chunk_id: int
    num_rows: int
    start_ts: int
    end_ts: int
    vectors: Tuple[bytes, ...]


# -- record codecs (the frame payload stays the legacy encoding) -------------

def _encode_chunk_record(part_key: bytes, chunk_id: int, num_rows: int,
                         start_ts: int, end_ts: int,
                         vectors: Sequence[bytes]) -> bytes:
    vec_lens = struct.pack(f"<{len(vectors)}i", *[len(v) for v in vectors])
    return (_CHUNK_HDR.pack(_CHUNK_MAGIC, len(part_key), len(vectors), 0,
                            chunk_id, num_rows, start_ts, end_ts)
            + part_key + vec_lens + b"".join(vectors))


def _decode_chunk_record(buf: bytes, off: int = 0) -> PersistedChunk:
    if off + _CHUNK_HDR.size > len(buf):
        raise ValueError("truncated chunk record header")
    magic, pk_len, ncols, _, cid, nrows, st, en = \
        _CHUNK_HDR.unpack_from(buf, off)
    if magic != _CHUNK_MAGIC:
        raise ValueError(f"bad chunk record magic 0x{magic:04x}")
    p = off + _CHUNK_HDR.size
    if p + pk_len + 4 * ncols > len(buf):
        raise ValueError("truncated chunk record body")
    pk = buf[p:p + pk_len]
    p += pk_len
    vec_lens = struct.unpack_from(f"<{ncols}i", buf, p)
    p += 4 * ncols
    vecs = []
    for vl in vec_lens:
        if vl < 0 or p + vl > len(buf):
            raise ValueError("truncated chunk record vectors")
        vecs.append(buf[p:p + vl])
        p += vl
    return PersistedChunk(pk, cid, nrows, st, en, tuple(vecs))


def _encode_pk_record(e: PartKeyEntry) -> bytes:
    return (_PK_HDR.pack(_PK_MAGIC, len(e.part_key), e.start_ts, e.end_ts)
            + e.part_key)


def _decode_pk_record(buf: bytes, off: int = 0) -> PartKeyEntry:
    if off + _PK_HDR.size > len(buf):
        raise ValueError("truncated partkey record header")
    magic, pk_len, st, en = _PK_HDR.unpack_from(buf, off)
    if magic != _PK_MAGIC:
        raise ValueError(f"bad partkey record magic 0x{magic:04x}")
    pk = buf[off + _PK_HDR.size:off + _PK_HDR.size + pk_len]
    if len(pk) < pk_len:
        raise ValueError("truncated partkey record body")
    return PartKeyEntry(pk, st, en)


def legacy_chunk_probe(buf: bytes, off: int) -> int:
    """Integrity-scanner probe for pre-framing chunk records: total
    length when a plausible record starts at ``off``, -1 torn, 0 not
    a legacy chunk record."""
    if off + 2 > len(buf) or \
            struct.unpack_from("<H", buf, off)[0] != _CHUNK_MAGIC:
        return 0
    if off + _CHUNK_HDR.size > len(buf):
        return -1
    _, pk_len, ncols, _, _, _, _, _ = _CHUNK_HDR.unpack_from(buf, off)
    p = off + _CHUNK_HDR.size + pk_len
    if p + 4 * ncols > len(buf):
        return -1
    vec_lens = struct.unpack_from(f"<{ncols}i", buf, p)
    if any(vl < 0 for vl in vec_lens):
        return 0
    total = _CHUNK_HDR.size + pk_len + 4 * ncols + sum(vec_lens)
    if total > integrity.MAX_PAYLOAD:
        return 0
    return total if off + total <= len(buf) else -1


def legacy_pk_probe(buf: bytes, off: int) -> int:
    """Integrity-scanner probe for pre-framing partkey records."""
    if off + 2 > len(buf) or \
            struct.unpack_from("<H", buf, off)[0] != _PK_MAGIC:
        return 0
    if off + _PK_HDR.size > len(buf):
        return -1
    _, pk_len, _, _ = _PK_HDR.unpack_from(buf, off)
    total = _PK_HDR.size + pk_len
    return total if off + total <= len(buf) else -1


class ColumnStore:
    """Abstract persistence API (ChunkSink + RawChunkSource + checkpoints)."""

    def write_chunks(self, dataset: str, shard: int, part_key: bytes,
                     chunks: Sequence) -> None:
        raise NotImplementedError

    def read_chunks(self, dataset: str, shard: int, part_key: bytes,
                    start_ts: int = 0, end_ts: int = 1 << 62
                    ) -> List[PersistedChunk]:
        raise NotImplementedError

    def write_part_keys(self, dataset: str, shard: int,
                        entries: Sequence[PartKeyEntry]) -> None:
        raise NotImplementedError

    def scan_part_keys(self, dataset: str, shard: int
                       ) -> Iterator[PartKeyEntry]:
        raise NotImplementedError

    def write_checkpoint(self, dataset: str, shard: int, group: int,
                         offset: int) -> None:
        raise NotImplementedError

    def read_checkpoints(self, dataset: str, shard: int) -> Dict[int, int]:
        raise NotImplementedError

    def delete_part_keys(self, dataset: str, shard: int,
                         part_keys: Sequence[bytes]) -> None:
        """Remove series (index entries + chunks) — the cardinality
        buster's primitive."""
        raise NotImplementedError

    def quarantined_records(self, dataset: str, shard: int) -> int:
        """Corrupt records this store has quarantined for the shard
        (0 for sinks with no durable files)."""
        return 0

    def close(self) -> None:
        pass


class NullColumnStore(ColumnStore):
    """No-op sink (store/ChunkSink.scala:126 NullColumnStore): memstore-only
    deployments and tests."""

    def write_chunks(self, dataset, shard, part_key, chunks) -> None:
        pass

    def read_chunks(self, dataset, shard, part_key, start_ts=0,
                    end_ts=1 << 62):
        return []

    def write_part_keys(self, dataset, shard, entries) -> None:
        pass

    def scan_part_keys(self, dataset, shard):
        return iter(())

    def write_checkpoint(self, dataset, shard, group, offset) -> None:
        pass

    def read_checkpoints(self, dataset, shard):
        return {}

    def delete_part_keys(self, dataset, shard, part_keys) -> None:
        pass


class FlatFileColumnStore(ColumnStore):
    """Append-only framed-log store. One writer per shard (the ingest
    thread), readers tolerate torn tails and quarantine corrupt records."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)
        # (dataset, shard) -> {part_key: {chunk_id: file offset}} lazy ODP
        # index; keyed by chunk_id so replayed/re-run appends upsert (last
        # record wins), matching the reference's Cassandra upsert semantics
        self._chunk_index: Dict[Tuple[str, int],
                                Dict[bytes, Dict[int, int]]] = {}
        # (dataset, shard) sets whose partkeys.log tail has been validated
        self._pk_validated: set = set()
        # quarantine bookkeeping: per-shard counts for the integrity
        # knob, and (path, offset) pairs already reported so re-scans
        # of a log (partkey scans re-read per call) don't double-count
        self._quarantined: Dict[Tuple[str, int], int] = {}
        self._seen_corrupt: Set[Tuple[str, int]] = set()

    # -- paths ------------------------------------------------------------
    def _shard_dir(self, dataset: str, shard: int) -> str:
        d = os.path.join(self.root, dataset, f"shard={shard}")
        os.makedirs(d, exist_ok=True)
        return d

    def _chunks_path(self, dataset: str, shard: int) -> str:
        return os.path.join(self._shard_dir(dataset, shard), "chunks.log")

    def _pk_path(self, dataset: str, shard: int) -> str:
        return os.path.join(self._shard_dir(dataset, shard), "partkeys.log")

    def _ckpt_path(self, dataset: str, shard: int) -> str:
        return os.path.join(self._shard_dir(dataset, shard),
                            "checkpoints.json")

    # -- integrity bookkeeping --------------------------------------------
    def _note_corrupt(self, path: str, kind: str, dataset: str, shard: int,
                      offset: int, data: bytes, reason: str,
                      action: str = "quarantined") -> None:
        mk = (path, int(offset))
        if mk in self._seen_corrupt:
            return
        self._seen_corrupt.add(mk)
        integrity.quarantine(path, kind, offset, data, reason,
                             action=action)
        key = (dataset, shard)
        self._quarantined[key] = self._quarantined.get(key, 0) + 1

    def quarantined_records(self, dataset: str, shard: int) -> int:
        return self._quarantined.get((dataset, shard), 0)

    def _scan_log(self, path: str, kind: str, read_point: str,
                  probe, dataset: str, shard: int,
                  truncate_tail: bool = True
                  ) -> Tuple[bytes, List[integrity.ScanRecord]]:
        """Load + classify one log. Corrupt regions quarantine (deduped
        across re-scans); a non-clean tail is truncated when the caller
        owns the writer side (a corrupt tail quarantines first — the
        truncate must never destroy the only copy of the bad bytes)."""
        if not os.path.exists(path):
            return b"", []
        with open(path, "rb") as f:
            buf = f.read()
        buf = chaos.filter_read(read_point, buf, dataset=dataset,
                                shard=shard)
        res = integrity.scan_buffer(buf, probe=probe)
        for reg in res.corrupt:
            self._note_corrupt(path, kind, dataset, shard, reg.offset,
                               buf[reg.offset:reg.offset + reg.length],
                               reg.reason)
        if res.tail_state != "clean" and truncate_tail:
            if res.tail_state == "corrupt":
                self._note_corrupt(path, kind, dataset, shard,
                                   res.tail_off, buf[res.tail_off:],
                                   res.tail_reason,
                                   action="quarantined-truncated")
            os.truncate(path, res.consumed)
        return buf, res.records

    # -- chunks (TimeSeriesChunksTable) ------------------------------------
    def write_chunks(self, dataset, shard, part_key, chunks) -> None:
        if not chunks:
            return
        path = self._chunks_path(dataset, shard)
        # building the index first also truncates any torn tail left by a
        # crash, so appends land at a valid record boundary (otherwise
        # everything after the torn bytes would be unreachable on replay)
        idx = self._ensure_chunk_index(dataset, shard)
        staged: List[Tuple[int, int]] = []
        f = open(path, "ab")
        start = f.tell()
        try:
            for c in chunks:
                off = f.tell()
                rec = _encode_chunk_record(part_key, c.id, c.num_rows,
                                           c.start_ts, c.end_ts, c.vectors)
                chaos.write("chunklog.write", f, integrity.encode_frame(rec),
                            dataset=dataset, shard=shard)
                staged.append((c.id, off))
            f.flush()
            os.fsync(f.fileno())
        except OSError:
            # all-or-nothing batch: flush whatever the buffer holds,
            # then cut the file back so no torn bytes stay mid-log
            try:
                f.close()
            except OSError:
                pass
            os.truncate(path, start)
            raise
        f.close()
        for cid, off in staged:
            idx.setdefault(part_key, {})[cid] = off

    def _iter_chunks(self, dataset, shard, offsets: Sequence[int]
                     ) -> Iterator[PersistedChunk]:
        """Read chunk records at known offsets (from _ensure_chunk_index,
        which validated framing). Every framed record is CRC-verified
        AGAIN here — the ODP read path never serves bytes that rotted
        between index build and fetch; a failing record quarantines and
        is skipped, never returned."""
        path = self._chunks_path(dataset, shard)
        if not os.path.exists(path):
            return
        with open(path, "rb") as f:
            for off in offsets:
                f.seek(off)
                hdr = f.read(_CHUNK_HDR.size)
                if len(hdr) < 2:
                    return
                (magic,) = struct.unpack_from("<H", hdr, 0)
                if magic == integrity.FRAME_MAGIC:
                    if len(hdr) < integrity.FRAME_HDR.size:
                        return
                    plen = integrity.FRAME_HDR.unpack_from(hdr, 0)[3]
                    total = integrity.FRAME_HDR.size + plen
                    if plen > integrity.MAX_PAYLOAD:
                        self._note_corrupt(
                            path, "chunklog", dataset, shard, off, hdr,
                            f"implausible frame length {plen}",
                            action="skipped")
                        continue
                    full = (hdr + f.read(max(0, total - len(hdr))))[:total]
                    full = chaos.filter_read("chunklog.read", full,
                                             dataset=dataset, shard=shard,
                                             offset=off)
                    try:
                        payload, _ = integrity.decode_frame(full)
                        if payload is None:
                            raise integrity.FrameError("truncated frame")
                        yield _decode_chunk_record(payload)
                    except (integrity.FrameError, ValueError,
                            struct.error) as e:
                        self._note_corrupt(
                            path, "chunklog", dataset, shard, off, full,
                            f"read-time verification failed: {e}",
                            action="skipped")
                    continue
                # legacy unframed record (no CRC: struct checks only)
                if len(hdr) < _CHUNK_HDR.size:
                    return
                magic, pk_len, ncols, _, cid, nrows, st, en = \
                    _CHUNK_HDR.unpack(hdr)
                if magic != _CHUNK_MAGIC:
                    self._note_corrupt(path, "chunklog", dataset, shard,
                                       off, hdr,
                                       f"bad chunk record magic "
                                       f"0x{magic:04x}", action="skipped")
                    continue
                rest = f.read(pk_len + 4 * ncols)
                if len(rest) < pk_len + 4 * ncols:
                    return
                try:
                    vec_lens = struct.unpack(f"<{ncols}i", rest[pk_len:])
                except struct.error:
                    self._note_corrupt(path, "chunklog", dataset, shard,
                                       off, hdr + rest,
                                       "undecodable vector lengths",
                                       action="skipped")
                    continue
                vbytes = f.read(sum(max(0, vl) for vl in vec_lens))
                full = chaos.filter_read("chunklog.read",
                                         hdr + rest + vbytes,
                                         dataset=dataset, shard=shard,
                                         offset=off)
                try:
                    yield _decode_chunk_record(full)
                except (ValueError, struct.error) as e:
                    self._note_corrupt(
                        path, "chunklog", dataset, shard, off, full,
                        f"read-time decode failed: {e}", action="skipped")

    def _ensure_chunk_index(self, dataset, shard
                            ) -> Dict[bytes, Dict[int, int]]:
        """Scan the log once, building {pk: {chunk_id: offset}}. The
        scan verifies every frame, quarantines corrupt regions (the
        index simply omits them — they can never reach a query), and
        truncates the tail to the last valid boundary so subsequent
        appends stay reachable."""
        key = (dataset, shard)
        idx = self._chunk_index.get(key)
        if idx is not None:
            return idx
        idx = {}
        path = self._chunks_path(dataset, shard)
        buf, records = self._scan_log(path, "chunklog", "chunklog.read",
                                      legacy_chunk_probe, dataset, shard)
        for rec in records:
            payload = buf[rec.payload_off:rec.payload_off + rec.payload_len]
            try:
                chunk = _decode_chunk_record(payload)
            except (ValueError, struct.error) as e:
                self._note_corrupt(path, "chunklog", dataset, shard,
                                   rec.offset,
                                   buf[rec.offset:rec.offset + rec.length],
                                   f"undecodable chunk record: {e}")
                continue
            idx.setdefault(chunk.part_key, {})[chunk.chunk_id] = rec.offset
        self._chunk_index[key] = idx
        return idx

    def read_chunks(self, dataset, shard, part_key, start_ts=0,
                    end_ts=1 << 62) -> List[PersistedChunk]:
        """ODP read path (readRawPartitions, CassandraColumnStore.scala:699).
        First call per shard builds an in-memory offset index (one scan).
        Duplicate appends of the same chunk_id (crash replay, re-run batch
        jobs) dedupe via the index — last record wins, like a C* upsert."""
        idx = self._ensure_chunk_index(dataset, shard)
        offs = sorted(idx.get(part_key, {}).values())
        out = [c for c in self._iter_chunks(dataset, shard, offs)
               if c.end_ts >= start_ts and c.start_ts <= end_ts]
        out.sort(key=lambda c: c.start_ts)
        return out

    # -- partkeys (PartitionKeysTable) -------------------------------------
    def _validate_pk_log(self, dataset, shard) -> None:
        """Scan partkeys.log once: quarantine corrupt regions, truncate
        the tail so appends stay reachable."""
        key = (dataset, shard)
        if key in self._pk_validated:
            return
        self._scan_log(self._pk_path(dataset, shard), "partkeys",
                       "partkeys.read", legacy_pk_probe, dataset, shard)
        self._pk_validated.add(key)

    def write_part_keys(self, dataset, shard, entries) -> None:
        if not entries:
            return
        self._validate_pk_log(dataset, shard)
        path = self._pk_path(dataset, shard)
        f = open(path, "ab")
        start = f.tell()
        try:
            for e in entries:
                chaos.write("partkeys.write", f,
                            integrity.encode_frame(_encode_pk_record(e)),
                            dataset=dataset, shard=shard)
            f.flush()
            os.fsync(f.fileno())
        except OSError:
            try:
                f.close()
            except OSError:
                pass
            os.truncate(path, start)
            raise
        f.close()

    def scan_part_keys(self, dataset, shard) -> Iterator[PartKeyEntry]:
        """Latest entry wins per partkey (upsert-by-append). Corrupt
        records quarantine and are skipped — a damaged entry never
        resurrects a series nor hides a healthy one behind a halt."""
        self._validate_pk_log(dataset, shard)
        path = self._pk_path(dataset, shard)
        # no tail truncate on the read path: validate above owns that
        buf, records = self._scan_log(path, "partkeys", "partkeys.read",
                                      legacy_pk_probe, dataset, shard,
                                      truncate_tail=False)
        latest: Dict[bytes, PartKeyEntry] = {}
        for rec in records:
            payload = buf[rec.payload_off:rec.payload_off + rec.payload_len]
            try:
                e = _decode_pk_record(payload)
            except (ValueError, struct.error) as err:
                self._note_corrupt(path, "partkeys", dataset, shard,
                                   rec.offset,
                                   buf[rec.offset:rec.offset + rec.length],
                                   f"undecodable partkey record: {err}")
                continue
            latest[e.part_key] = e
        return iter(latest.values())

    def delete_part_keys(self, dataset, shard, part_keys) -> None:
        """Compact both logs without the doomed series (the append-only
        analogue of the reference cardbuster's Cassandra deletes). One
        writer per shard is the store's standing contract, so the
        rewrite is safe against concurrent appends. Survivors are
        rewritten FRAMED — compaction migrates legacy files to the
        checksummed format."""
        doomed = set(part_keys)
        if not doomed:
            return
        # part keys: rewrite keeping the LATEST entry per surviving key
        self._validate_pk_log(dataset, shard)
        pk_path = self._pk_path(dataset, shard)
        survivors = [e for e in self.scan_part_keys(dataset, shard)
                     if e.part_key not in doomed]
        tmp = pk_path + ".tmp"
        with open(tmp, "wb") as f:
            for e in survivors:
                f.write(integrity.encode_frame(_encode_pk_record(e)))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, pk_path)
        # chunks: rewrite the log without the doomed keys' records
        idx = self._ensure_chunk_index(dataset, shard)
        ch_path = self._chunks_path(dataset, shard)
        keep_offs = sorted(off for pk, chunks in idx.items()
                           if pk not in doomed
                           for off in chunks.values())
        tmp = ch_path + ".tmp"
        with open(tmp, "wb") as f:
            for c in self._iter_chunks(dataset, shard, keep_offs):
                f.write(integrity.encode_frame(_encode_chunk_record(
                    c.part_key, c.chunk_id, c.num_rows, c.start_ts,
                    c.end_ts, c.vectors)))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, ch_path)
        self._chunk_index.pop((dataset, shard), None)
        # the rewritten files have fresh offsets: drop stale dedup marks
        self._seen_corrupt = {mk for mk in self._seen_corrupt
                              if mk[0] not in (pk_path, ch_path)}

    # -- checkpoints (CheckpointTable.scala:26) ----------------------------
    def write_checkpoint(self, dataset, shard, group, offset) -> None:
        path = self._ckpt_path(dataset, shard)
        cur = self.read_checkpoints(dataset, shard)
        cur[group] = offset
        data = integrity.encode_checkpoint(
            {str(k): v for k, v in cur.items()})
        tmp = path + ".tmp"
        try:
            with open(tmp, "wb") as f:
                chaos.write("checkpoint.write", f, data,
                            dataset=dataset, shard=shard)
                f.flush()
                os.fsync(f.fileno())
        except OSError:
            # the atomic-replace never ran: the live checkpoint is
            # intact, just drop the partial temp file
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        os.replace(tmp, path)
        self._seen_corrupt.discard((path, 0))

    def read_checkpoints(self, dataset, shard) -> Dict[int, int]:
        path = self._ckpt_path(dataset, shard)
        if not os.path.exists(path):
            return {}
        try:
            with open(path, "rb") as f:
                raw = f.read()
        except OSError:
            return {}
        raw = chaos.filter_read("checkpoint.read", raw, dataset=dataset,
                                shard=shard)
        try:
            data, _ = integrity.decode_checkpoint(raw)
            return {int(k): int(v) for k, v in data.items()}
        except (integrity.FrameError, TypeError, ValueError) as e:
            # a damaged checkpoint quarantines and reads as empty:
            # replay restarts from offset 0, which is safe (chunk and
            # partkey appends upsert; re-ingest is idempotent)
            self._note_corrupt(path, "checkpoint", dataset, shard, 0,
                               raw, f"checkpoint verification failed: {e}")
            return {}
