"""In-memory time-series store: shards, partitions, write buffers, chunks.

TPU-native re-design of the reference's memstore
(core/src/main/scala/filodb.core/memstore/TimeSeriesShard.scala:258,
TimeSeriesPartition.scala:64, TimeSeriesMemStore.scala:26,
WriteBufferPool.scala:34, store/ChunkSetInfo.scala:32).

Key departures from the JVM design, chosen for the TPU execution model:

- No off-heap Unsafe pointers: write buffers are plain Python/numpy appenders;
  encoded chunks are immutable ``bytes`` (the interchange format from
  filodb_tpu_torch.memory.vectors).  The reference's ChunkMap spin-locks and
  EvictionLock exist to let queries iterate shared mutable off-heap memory
  safely; here queries only ever see **immutable published chunk lists** plus
  a snapshot of the in-progress buffer tail, so the whole lock apparatus is
  replaced by snapshot semantics (SURVEY.md §7 "immutable-snapshot design").

- Flush groups (TimeSeriesShard.scala:1253 createFlushTasks): partitions hash
  into ``num_groups`` subgroups; flushing a group encodes that group's write
  buffers into chunks and records a checkpoint offset, exactly like the
  reference's interleaved flush/ingest protocol, minus the actor machinery.

- Queries hitting recent data merge the encoded chunks with the current
  write-buffer snapshot (the reference reads write buffers through the same
  BinaryVector API; here the tail is just small host arrays appended to the
  decoded chunk arrays).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import (Callable, Dict, Iterable, List, Mapping, Optional,
                    Sequence, Tuple)

import numpy as np

from filodb_tpu_torch.core.index import (END_TIME_INGESTING, ColumnFilter, TagIndex)
from filodb_tpu_torch.core.record import PartKey, RecordContainer
from filodb_tpu_torch.lint.caches import cache_registry, event_source, publishes
from filodb_tpu_torch.lint.locks import guarded_by, single_writer
from filodb_tpu_torch.core.schemas import (ColumnType, DataSchema, DatasetRef,
                                     Schemas)
from filodb_tpu_torch.memory import histogram as bh
from filodb_tpu_torch.memory import vectors as bv

DEFAULT_MAX_CHUNK_ROWS = 400  # store config max-chunks-size (IngestionConfig)


def chunk_id(start_ts: int, seq: int) -> int:
    """chunkID = startTime << 12 | seq (core/store/package.scala chunkID)."""
    return (start_ts << 12) | (seq & 0xFFF)


@dataclass
class ChunkSetInfo:
    """Per-chunk metadata (store/ChunkSetInfo.scala:32 — 32-byte metadata:
    id, numRows, startTime, endTime + per-column vector ptrs)."""
    id: int
    num_rows: int
    start_ts: int
    end_ts: int
    vectors: Tuple[bytes, ...]  # column 0 = timestamps

    def decode_column(self, i: int):
        return bv.decode(self.vectors[i]) if i == 0 or not _is_hist(
            self.vectors[i]) else bh.decode_histograms(self.vectors[i])


def _is_hist(buf: bytes) -> bool:
    return buf[:1] in (bytes([bh.K_HIST_2D]), bytes([bh.K_HIST_SECT]))


# the caches are shared by concurrent HTTP query threads; the chunk list
# itself is append-only and read via snapshots, so only the caches (and
# the publish step in switch_buffers) ride the lock.
# Cache inventory: both caches validate against the chunk-set length at
# read time (decoded prefix extends to len(chunks), a merge entry is
# keyed by (n_chunks, tail_len)) — graftlint requires the read hooks to
# keep consulting the chunk-set event source.
@cache_registry("partition-decode", keyed=("column",),
                validated_by={"chunk-set": ("read_full",
                                            "hist_drop_rows")})
@cache_registry("partition-merge", keyed=("column",),
                validated_by={"chunk-set": ("read_full",)})
# the selection memo validates against the write stamp: every chunk-set
# publish, buffered row, eviction and page-in changes it
@cache_registry("partition-select", keyed=("column", "write-stamp"),
                validated_by={"chunk-set": ("select_record",)})
@guarded_by("_cache_lock", "_decode_cache", "_merge_cache", "_select_memo")
class TimeSeriesPartition:
    """One time series in one shard (memstore/TimeSeriesPartition.scala:64).

    Write path: ``ingest`` appends to the current write buffer; when the
    buffer reaches ``max_chunk_rows`` (or on flush-group flush) the buffer is
    encoded to an immutable chunk (``encodeOneChunkset`` :248 equivalent) and
    published to ``chunks``."""

    __slots__ = ("part_id", "part_key", "schema", "chunks", "_ts_buf",
                 "_col_bufs", "_buf_rows", "_hist_scheme",
                 "max_chunk_rows", "_chunk_seq",
                 "ingested", "ooo_dropped", "_decode_cache", "_merge_cache",
                 "persisted_chunks", "odp_pending", "_cache_lock",
                 "card_active", "on_encode", "_select_memo", "_page_epoch")

    def __init__(self, part_id: int, part_key: PartKey, schema: DataSchema,
                 max_chunk_rows: int = DEFAULT_MAX_CHUNK_ROWS):
        self.part_id = part_id
        self.part_key = part_key
        self.schema = schema
        self.chunks: List[ChunkSetInfo] = []
        # write buffers are SEGMENT lists: each ingest run appends one
        # numpy array slice (no per-row Python element churn); histogram
        # columns keep per-row [nb] arrays. Row count tracked separately.
        self._ts_buf: List[np.ndarray] = []
        self._col_bufs: List[List] = [[] for _ in schema.data_columns]
        self._buf_rows = 0
        self._hist_scheme = None
        self.max_chunk_rows = max_chunk_rows
        self._chunk_seq = 0
        self.ingested = 0
        self.ooo_dropped = 0
        # col_index -> [n_chunks_decoded, ts_parts, val_parts, concat pair]
        self._decode_cache: Dict[int, list] = {}
        # col_index -> (n_chunks, tail_len, ts, vals): last chunks+tail
        # merge, reused until either side changes (per-scrape, not per-query)
        self._merge_cache: Dict[int, Tuple] = {}
        # col_index -> (write stamp, ts, vals, record): select_record's
        # memo, reused until the stamp moves
        self._select_memo: Dict[int, Tuple] = {}
        # bumped (under _cache_lock) by eviction and page-in, the writes
        # that rebind `chunks` rather than append to it
        self._page_epoch = 0
        self.persisted_chunks = 0   # prefix of `chunks` already in the store
        self.odp_pending = False    # True: chunks live in the ColumnStore
        self.card_active = True     # counted as active in the tracker
        self.on_encode = None       # chunk-encoded hook (flush downsample)
        # guards _decode_cache/_merge_cache population: concurrent HTTP
        # query threads share these caches (the chunk list itself is only
        # appended to, and readers work off a snapshot length)
        self._cache_lock = threading.Lock()

    # -- write path -------------------------------------------------------
    def ingest(self, timestamp: int, values: Sequence) -> bool:
        """Append one row.  Out-of-order / duplicate timestamps within the
        partition are dropped (TimeSeriesPartition.scala ingest OOO rules).
        Returns True if ingested."""
        last = self.last_timestamp
        if last is not None and timestamp <= last:
            self.ooo_dropped += 1
            return False
        self._ts_buf.append(np.asarray([int(timestamp)], dtype=np.int64))
        for buf, col, v in zip(self._col_bufs, self.schema.data_columns, values):
            if col.col_type == ColumnType.HISTOGRAM:
                scheme, counts = v
                if self._hist_scheme is None:
                    self._hist_scheme = scheme
                buf.append(np.asarray(counts, dtype=np.int64))
            elif col.col_type == ColumnType.STRING:
                buf.append("" if v is None else str(v))
            else:
                buf.append(np.asarray([v], dtype=np.float64))
        self._buf_rows += 1
        self.ingested += 1
        if self._buf_rows >= self.max_chunk_rows:
            self.switch_buffers()
        return True

    def ingest_batch(self, timestamps: Sequence[int],
                     col_values: Sequence[Sequence]) -> int:
        """Append a run of rows for this partition in one shot.

        Fast path: a strictly-increasing run starting after the current
        last timestamp lands as whole numpy SEGMENTS in the write
        buffers — O(1) Python work per run, no per-row element churn
        (the batched analogue of the reference's per-row appender adds).
        Anything else falls back to the per-row path so OOO-drop
        semantics stay identical. Returns rows ingested."""
        n_in = len(timestamps)
        if n_in == 0:
            return 0
        if n_in == 1:
            return 1 if self.ingest(timestamps[0], [c[0] for c
                                                    in col_values]) else 0
        ts = np.asarray(timestamps, dtype=np.int64)
        last = self.last_timestamp
        sorted_run = bool(np.all(np.diff(ts) > 0)) and \
            (last is None or int(ts[0]) > last)
        if not sorted_run:
            n = 0
            for i in range(n_in):
                if self.ingest(timestamps[i],
                               [c[i] for c in col_values]):
                    n += 1
            return n
        hist_cols = [i for i, c in enumerate(self.schema.data_columns)
                     if c.col_type == ColumnType.HISTOGRAM]
        str_cols = [i for i, c in enumerate(self.schema.data_columns)
                    if c.col_type == ColumnType.STRING]
        col_arrays = [None if ci in hist_cols or ci in str_cols
                      else np.asarray(col_values[ci], dtype=np.float64)
                      for ci in range(len(self._col_bufs))]
        pos = 0
        while pos < n_in:
            room = self.max_chunk_rows - self._buf_rows
            take = min(room, n_in - pos)
            # copy: a view would pin the container's WHOLE column array
            # in memory for as long as any segment sits in the buffer
            self._ts_buf.append(np.array(ts[pos:pos + take]))
            for ci, buf in enumerate(self._col_bufs):
                if ci in hist_cols:
                    vals = col_values[ci]
                    for k in range(pos, pos + take):
                        scheme, counts = vals[k]
                        if self._hist_scheme is None:
                            self._hist_scheme = scheme
                        buf.append(np.asarray(counts, dtype=np.int64))
                elif ci in str_cols:
                    vals = col_values[ci]
                    for k in range(pos, pos + take):
                        v = vals[k]
                        buf.append("" if v is None else str(v))
                else:
                    buf.append(np.array(col_arrays[ci][pos:pos + take]))
            self._buf_rows += take
            pos += take
            if self._buf_rows >= self.max_chunk_rows:
                self.switch_buffers()
        self.ingested += n_in
        return n_in

    @property
    def last_timestamp(self) -> Optional[int]:
        if self._buf_rows:
            return int(self._ts_buf[-1][-1])
        if self.chunks:
            return self.chunks[-1].end_ts
        return None

    @property
    def earliest_timestamp(self) -> Optional[int]:
        if self.chunks:
            return self.chunks[0].start_ts
        return int(self._ts_buf[0][0]) if self._buf_rows else None

    @publishes("chunk-set")
    def switch_buffers(self) -> Optional[ChunkSetInfo]:
        """Encode the current write buffer into an immutable chunk
        (TimeSeriesPartition.scala:229 switchBuffers / :248 encodeOneChunkset).
        """
        if not self._buf_rows:
            return None
        ts = np.concatenate(self._ts_buf)
        vecs: List[bytes] = [bv.encode_longs(ts)]
        for buf, col in zip(self._col_bufs, self.schema.data_columns):
            if col.col_type == ColumnType.HISTOGRAM:
                rows = np.stack(buf) if buf else np.zeros((0, 0), np.int64)
                vecs.append(bh.encode_histograms(
                    self._hist_scheme, rows, counter=col.counter))
            elif col.col_type == ColumnType.STRING:
                vecs.append(bv.encode_strings(buf))
            else:
                vecs.append(bv.encode_doubles(
                    np.concatenate(buf) if buf
                    else np.zeros(0, dtype=np.float64),
                    counter=col.detect_drops))
        info = ChunkSetInfo(
            id=chunk_id(int(ts[0]), self._chunk_seq),
            num_rows=ts.size,
            start_ts=int(ts[0]),
            end_ts=int(ts[-1]),
            vectors=tuple(vecs),
        )
        self._chunk_seq += 1
        # publish atomically w.r.t. readers: a reader must never see the new
        # chunk AND the old buffer tail (double count) or neither (drop)
        with self._cache_lock:
            self.chunks.append(info)
            self._ts_buf = []
            self._col_bufs = [[] for _ in self.schema.data_columns]
            self._buf_rows = 0
        if self.on_encode is not None:
            # flush-time downsample emission rides every encode, including
            # buffer-full encodes during ingest (ShardDownsampler.scala:40)
            self.on_encode(self.part_key, self.schema, info)
        return info

    # -- read path --------------------------------------------------------
    def buffer_snapshot(self):
        """Snapshot of the un-encoded tail: (ts array, per-column tails —
        float64 arrays for plain columns, per-row lists for histograms).

        Ingest appends the timestamp segment first, then each column
        segment, so the longest consistent prefix across all buffers is a
        valid row set even when a writer thread is mid-append."""
        ts_segs = list(self._ts_buf)
        ts = (np.concatenate(ts_segs) if ts_segs
              else np.zeros(0, dtype=np.int64))
        snaps, counts = [], []
        for buf, col in zip(self._col_bufs, self.schema.data_columns):
            b = list(buf)
            if col.col_type in (ColumnType.HISTOGRAM, ColumnType.STRING):
                snaps.append(b)
                counts.append(len(b))
            else:
                arr = (np.concatenate(b) if b
                       else np.zeros(0, dtype=np.float64))
                snaps.append(arr)
                counts.append(arr.size)
        n = min([ts.size] + counts) if counts else ts.size
        return ts[:n], [c[:n] for c in snaps]

    def _decoded_chunk_arrays(self, col_index: int
                              ) -> Tuple[np.ndarray, np.ndarray]:
        """Decoded concatenation of all PUBLISHED chunks for one column,
        cached incrementally: only chunks appended since the last call are
        decoded. This is the host mirror of the device tile store — decode
        cost is paid once per chunk, not once per query."""
        col = self.schema.columns[col_index]
        with self._cache_lock:
            return self._decoded_chunk_arrays_locked(col_index, col)

    @event_source("chunk-set")
    def _decoded_chunk_arrays_locked(self, col_index: int, col):
        """Body of _decoded_chunk_arrays; caller holds ``_cache_lock``.

        Entry layout: [next_chunk, ts_parts, val_parts, concat,
        drop_rows, rows_so_far, prev_last_row]. The last three exist for
        histogram columns only: drop_rows accumulates GLOBAL reset row
        indices from each chunk's sectioned drop table (legacy unsectioned
        chunks are rescanned once at decode), plus cross-chunk boundary
        resets — so query-time counter correction never rescans buckets."""
        entry = self._decode_cache.get(col_index)
        if entry is None:
            entry = [0, [], [], None, [], 0, None]
            self._decode_cache[col_index] = entry
        n = len(self.chunks)
        if entry[0] < n:
            for c in self.chunks[entry[0]:n]:
                entry[1].append(bv.decode_longs(c.vectors[0]))
                if col.col_type == ColumnType.HISTOGRAM:
                    _, _, vals, drops = bh.decode_histograms_full(
                        c.vectors[col_index])
                    if drops is None:           # legacy K_HIST_2D chunk
                        drops = bh.detect_drop_rows(vals)
                    off, prev = entry[5], entry[6]
                    if (prev is not None and vals.shape[0]
                            and (vals[0] < prev).any()):
                        entry[4].append(np.array([off], dtype=np.int64))
                    if drops.size:
                        entry[4].append(drops + off)
                    entry[5] = off + vals.shape[0]
                    if vals.shape[0]:
                        entry[6] = vals[-1]
                    entry[2].append(vals)
                elif col.col_type == ColumnType.STRING:
                    vals = bv.decode_strings(c.vectors[col_index])
                    entry[2].append(vals)
                else:
                    vals = bv.decode_doubles(c.vectors[col_index])
                    entry[2].append(vals)
            entry[0] = n
            entry[3] = None
        if entry[3] is None:
            if entry[1]:
                cat = (np.concatenate(entry[1]),
                       np.concatenate(entry[2], axis=0))
                # collapse parts into the concatenation (no 2x residency);
                # future chunks append after it
                entry[1] = [cat[0]]
                entry[2] = [cat[1]]
            else:
                col_empty = (np.zeros((0, 0))
                             if col.col_type == ColumnType.HISTOGRAM
                             else np.zeros(0, dtype=object)
                             if col.col_type == ColumnType.STRING
                             else np.zeros(0))
                cat = (np.zeros(0, dtype=np.int64), col_empty)
            # cache-backed arrays are shared with query results: freeze them
            for a in cat:
                a.setflags(write=False)
            entry[3] = cat
        return entry[0], entry[3]

    def read_full(self, col_index: int
                  ) -> Tuple[np.ndarray, np.ndarray, int]:
        """All samples of one data column: published chunks (cached decode)
        + current write-buffer tail. Returns (ts, vals, chunk_len) where
        chunk_len is the length of the chunk-backed (immutable) prefix —
        downstream device caches key on it (num_chunks pins its content)."""
        return self._read_full(col_index)[:3]

    def _read_full(self, col_index: int
                   ) -> Tuple[np.ndarray, np.ndarray, int, int]:
        """read_full plus the number of chunks its prefix holds, taken
        under the same lock as the prefix."""
        col = self.schema.columns[col_index]
        # one lock acquisition covers decode AND the tail snapshot: a
        # switch_buffers publishing the tail as a chunk between the two
        # would otherwise double-count (chunk seen + tail still seen) or
        # drop (neither seen) those rows
        with self._cache_lock:
            n_chunks, (cts, cvals) = \
                self._decoded_chunk_arrays_locked(col_index, col)
            buf_ts, buf_cols = self.buffer_snapshot()
            # merge-cache bookkeeping stays under the same acquisition:
            # a concurrent reader's pop must never race this thread's
            # get/set on the shared dict (graftlint lock-guarded-access)
            if not buf_ts.size:
                self._merge_cache.pop(col_index, None)
                cached = None
            else:
                cached = self._merge_cache.get(col_index)
        if not buf_ts.size:
            return cts, cvals, cts.size, n_chunks
        if cached is not None and cached[0] == n_chunks \
                and cached[1] == buf_ts.size:
            return cached[2], cached[3], cts.size, n_chunks
        if col.col_type == ColumnType.HISTOGRAM:
            rows = buf_cols[col_index - 1]
            tail = (np.stack(rows).astype(np.float64) if rows
                    else np.zeros((0, cvals.shape[1]
                                   if cvals.ndim == 2 else 0)))
            if cvals.ndim == 2 and tail.ndim == 2 \
                    and cvals.shape[1] != tail.shape[1] and cvals.size == 0:
                cvals = np.zeros((0, tail.shape[1]))
        elif col.col_type == ColumnType.STRING:
            tail = np.asarray(buf_cols[col_index - 1], dtype=object)
        else:
            tail = np.asarray(buf_cols[col_index - 1], dtype=np.float64)
        mts = np.concatenate([cts, buf_ts])
        mvals = np.concatenate([cvals, tail], axis=0)
        mts.setflags(write=False)
        mvals.setflags(write=False)
        with self._cache_lock:
            self._merge_cache[col_index] = (n_chunks, buf_ts.size,
                                            mts, mvals)
        return mts, mvals, cts.size, n_chunks

    def select_record(self, col_index: int, build: Callable, *args):
        """One column's selection record, memoized until a write changes
        what ``read_full`` returns. Returns (record, hit).

        On a miss, ``build(self, col_index, ts, vals, chunk_len,
        num_chunks, *args)`` makes the record from one ``read_full``
        (``num_chunks`` from the same lock as ``chunk_len``). The write
        stamp is taken BEFORE that read and under ``_cache_lock``, and
        every write moves it: ingest raises the buffered row count only
        after its rows are appended, ``switch_buffers`` adds a chunk and
        empties the buffer under the lock, eviction and page-in bump
        ``_page_epoch`` under it. So a stamp is always a state that
        existed (never a published chunk beside the tail it came from), a
        record never holds less than its stamp's state, and a record that
        raced a write carries a stamp no later state has: the next lookup
        misses and rebuilds."""
        with self._cache_lock:
            stamp = (self._page_epoch, len(self.chunks), self._buf_rows)
            memo = self._select_memo.get(col_index)
        if memo is not None and memo[0] == stamp:
            return memo[3], True
        ts, vals, chunk_len, n_chunks = self._read_full(col_index)
        rec = build(self, col_index, ts, vals, chunk_len, n_chunks, *args)
        with self._cache_lock:
            self._select_memo[col_index] = (stamp, ts, vals, rec)
        return rec, False

    def hist_drop_rows(self, col_index: int) -> np.ndarray:
        """Global reset row indices over this histogram column's full
        (chunks + buffer tail) row sequence, from the sectioned drop
        tables — readers hand these to hist_counter_correction instead of
        rescanning (SectDelta's read-side payoff)."""
        with self._cache_lock:
            _, _ = self._decoded_chunk_arrays_locked(
                col_index, self.schema.columns[col_index])
            entry = self._decode_cache[col_index]
            chunk_drops = (np.concatenate(entry[4]) if entry[4]
                           else np.zeros(0, dtype=np.int64))
            off, prev = entry[5], entry[6]
            buf_ts, buf_cols = self.buffer_snapshot()
        if not buf_ts.size:
            return chunk_drops
        rows = buf_cols[col_index - 1]
        tail = np.stack(rows).astype(np.float64) if rows else \
            np.zeros((0, 0))
        parts = [chunk_drops]
        if prev is not None and tail.shape[0] and tail.shape[1] \
                and (tail[0] < prev).any():
            parts.append(np.array([off], dtype=np.int64))
        tail_drops = bh.detect_drop_rows(tail)
        if tail_drops.size:
            parts.append(tail_drops + off)
        return np.concatenate(parts)

    def cache_bytes(self) -> int:
        """Bytes held by this partition's decode + merge caches (the
        ``filodb_decode_cache_bytes`` gauge input)."""
        with self._cache_lock:
            return self._cache_bytes_locked()

    def _cache_bytes_locked(self) -> int:
        n = 0
        held = set()
        for entry in self._decode_cache.values():
            for part in entry[1]:
                n += int(part.nbytes)
            for part in entry[2]:
                n += int(getattr(part, "nbytes", 0))
            if entry[3] is not None:
                held.update(map(id, entry[3]))
        for cached in self._merge_cache.values():
            n += int(cached[2].nbytes) + int(getattr(cached[3],
                                                     "nbytes", 0))
            held.update((id(cached[2]), id(cached[3])))
        # a selection record shares the caches' arrays; one left behind
        # by a write keeps the arrays it was built over until rebuilt
        for memo in self._select_memo.values():
            for a in memo[1:3]:
                if id(a) not in held:
                    n += int(getattr(a, "nbytes", 0))
        return n

    def _drop_caches_locked(self) -> None:
        """Forget every decode, merge and selection entry (caller holds
        ``_cache_lock``)."""
        self._decode_cache.clear()
        self._merge_cache.clear()
        self._select_memo.clear()

    def release_caches(self) -> int:
        """Drop the decoded-chunk and merge caches when every published
        chunk sits in the flushed/persisted prefix — those decodes are
        pure duplicates of immutable chunk bytes (re-decodable on the
        next read), so under memory pressure they are the first thing to
        give back. Partitions with unflushed chunks keep their caches
        (they are the hot, actively-queried head). Returns bytes freed."""
        with self._cache_lock:
            if self.persisted_chunks < len(self.chunks):
                return 0
            n = self._cache_bytes_locked()
            self._drop_caches_locked()
            return n

    @property
    def num_chunks(self) -> int:
        return len(self.chunks)


@single_writer("per-shard counters: mutated only by the shard's owning "
               "thread (ingest driver, or bootstrap strictly before it)")
@dataclass
class ShardStats:
    """Kamon-equivalent gauges (TimeSeriesShardStats, TimeSeriesShard.scala:41).
    """
    rows_ingested: int = 0
    rows_skipped: int = 0
    out_of_order_dropped: int = 0
    num_series: int = 0
    chunks_encoded: int = 0
    encoded_bytes: int = 0
    flushes_done: int = 0
    partitions_evicted: int = 0
    chunks_persisted: int = 0
    partitions_paged_in: int = 0    # ODP page-ins (ChunkSourceStats)
    partitions_bootstrapped: int = 0
    quota_dropped_series: int = 0   # new series rejected by cardinality


@single_writer("shard state is mutated only by the shard's single "
               "writer (the per-shard ingest thread; adopt/crash "
               "bootstrap runs strictly before the driver starts — the "
               "membership protocol pins the handoff happens-before); "
               "query threads read immutable snapshots, ODP page-in "
               "rides _odp_lock")
class TimeSeriesShard:
    """One shard: partKey -> partition map + tag index + flush groups
    (memstore/TimeSeriesShard.scala:258)."""

    def __init__(self, ref: DatasetRef, schemas: Schemas, shard_num: int,
                 num_groups: int = 8,
                 max_chunk_rows: int = DEFAULT_MAX_CHUNK_ROWS,
                 max_series: int = 1_000_000,
                 column_store: Optional[object] = None,
                 card_tracker: Optional[object] = None,
                 flush_downsampler: Optional[object] = None):
        self.ref = ref
        self.schemas = schemas
        self.shard_num = shard_num
        self.num_groups = num_groups
        self.max_chunk_rows = max_chunk_rows
        self.max_series = max_series  # cardinality quota (ratelimit/)
        # per-(ws,ns,metric) quota tree (ratelimit/CardinalityTracker)
        self.card_tracker = card_tracker
        # flush-time downsample emission (ShardDownsampler.scala:40)
        self.flush_downsampler = flush_downsampler
        self.column_store = column_store  # ChunkSink/RawChunkSource boundary
        self.partitions: Dict[int, TimeSeriesPartition] = {}
        self._by_part_key: Dict[bytes, int] = {}
        self._next_part_id = 0
        self.index = TagIndex()
        self.stats = ShardStats()
        # per-group ingestion checkpoint offsets (CheckpointTable semantics)
        self.checkpoints: Dict[int, int] = {}
        self._resident = 0      # running resident-sample count
        # settled-time lower bound (ms); -1 until the first row lands.
        # This is the MIN over per-partition last timestamps (ODP shells
        # contribute their persisted end time): the per-partition OOO
        # guard drops rows <= its own last, so no partition already in
        # the min-set can ever ingest at/below this watermark — steps
        # at/below it are settled, steps above it may still fill in
        # (a lagging series sits below faster ones and pins the min).
        # The results cache uses it as the freshness horizon; a
        # REGRESSION (new shard object replaying, adoption) signals
        # cached results built against this shard must be invalidated.
        self.ingest_watermark_ms = -1
        # monotone count of backfill events: a partition ENTERING the
        # min-set (new series, re-created series, shell without a
        # persisted end) whose first accepted row lands at/below the
        # watermark. Such rows dirty already-settled steps without
        # moving the watermark (the entrant's LAST may sit above it),
        # so the results cache invalidates on any epoch change.
        self.ingest_backfill_epoch = 0
        # storage-integrity state: how many corrupt records the durable
        # tier quarantined for this shard, and whether that loss tripped
        # the integrity-max-quarantined-records knob (the shard then
        # degrades to read-only — serving silently-partial data is the
        # one thing the integrity rail must never do). Written by the
        # single ingest thread, read racily by HTTP health threads,
        # same idiom as the watermark above.
        self.integrity_quarantined_records = 0
        self.integrity_read_only = False
        # serializes ODP page-ins (queries arrive from concurrent HTTP
        # threads; page-in rebinds part.chunks — everything else on the
        # read path sees immutable snapshots and needs no lock)
        self._odp_lock = threading.Lock()

    def update_integrity(self, stream_quarantined: int,
                         max_allowed: int) -> bool:
        """Refresh the shard's quarantine count (WAL + ColumnStore) and
        degrade to read-only when it exceeds ``max_allowed``. Returns
        the read-only state. Called from the ingest thread after reads
        and BEFORE applying a batch, so no records land after the knob
        trips."""
        total = int(stream_quarantined)
        cs = self.column_store
        if cs is not None and hasattr(cs, "quarantined_records"):
            total += cs.quarantined_records(self.ref.dataset,
                                            self.shard_num)
        self.integrity_quarantined_records = total
        if total > max_allowed and not self.integrity_read_only:
            self.integrity_read_only = True
            from filodb_tpu_torch.obs import events as obs_events
            from filodb_tpu_torch.obs import metrics as obs_metrics
            obs_metrics.GLOBAL_REGISTRY.gauge(
                "filodb_shard_integrity_read_only",
                "1 while the shard is degraded to read-only because "
                "quarantined-record loss exceeded the integrity knob"
            ).set(1.0, dataset=self.ref.dataset,
                  shard=str(self.shard_num))
            obs_events.emit("integrity-read-only",
                            dataset=self.ref.dataset, shard=self.shard_num,
                            quarantined=total, max_allowed=max_allowed)
        return self.integrity_read_only

    # -- ingest path ------------------------------------------------------
    def get_or_create_partition(self, part_key: PartKey, first_ts: int,
                                active: bool = True
                                ) -> Optional[TimeSeriesPartition]:
        """(TimeSeriesShard.scala:960 getOrAddPartitionForIngestion).
        ``active=False`` registers a recovered/bootstrapped shell that is
        counted in cardinality totals but not as actively ingesting."""
        kb = part_key.to_bytes()
        pid = self._by_part_key.get(kb)
        if pid is not None:
            return self.partitions[pid]
        if len(self.partitions) >= self.max_series:
            # shard-wide cap breach: drop new series
            self.stats.quota_dropped_series += 1
            return None
        if self.card_tracker is not None:
            from filodb_tpu_torch.core.cardinality import \
                QuotaReachedException
            try:
                self.card_tracker.modify_count(
                    self.card_tracker.prefix_of(part_key.label_map), 1,
                    1 if active else 0)
            except QuotaReachedException:
                # per-prefix quota breach: drop new series + stat
                # (QuotaExceededProtocol)
                self.stats.quota_dropped_series += 1
                return None
        schema = self.schemas.by_id(part_key.schema_id)
        pid = self._next_part_id
        self._next_part_id += 1
        part = TimeSeriesPartition(pid, part_key, schema, self.max_chunk_rows)
        part.card_active = active
        if self.flush_downsampler is not None:
            part.on_encode = self.flush_downsampler.on_chunk
        self.partitions[pid] = part
        self._by_part_key[kb] = pid
        self.index.add_part_key(pid, part_key.label_map, first_ts)
        self.stats.num_series = len(self.partitions)
        return part

    # the watermark/backfill-epoch mutation publishers: pull events —
    # the results cache re-reads them via its @event_source functions
    # on every lookup rather than being pushed to
    @publishes("watermark")
    @publishes("backfill-epoch")
    def ingest(self, container: RecordContainer, offset: int = -1) -> int:
        """Ingest one record container (TimeSeriesShard.scala:871).
        Returns number of rows ingested.

        Rows are processed in consecutive same-partition runs (builders
        emit per-series bursts), so the per-partition hot path is one
        batched buffer extension instead of a per-row Python loop."""
        n = 0
        tss, cols = container.arrays()
        wm_recompute = False
        for i, j, pk in container.runs():
            part = self.get_or_create_partition(pk, tss[i])
            if part is None:
                self.stats.rows_skipped += j - i
                continue
            if not part.card_active:
                # resumed ingest into a recovered/evicted shell
                part.card_active = True
                if self.card_tracker is not None:
                    self.card_tracker.modify_count(
                        self.card_tracker.prefix_of(pk.label_map), 0, 1)
            if part.odp_pending:
                # only page in when the run could overlap persisted history
                # (replay — the OOO guard then sees it); normal continuation
                # needs just the index end time, so restart recovery does
                # not trigger a full-retention read storm
                endt = self.index.end_time(part.part_id)
                if endt is not None and endt != END_TIME_INGESTING \
                        and min(tss[i:j]) <= endt:
                    # min of the whole run, not just the first row: an
                    # unsorted replay run may lead with a fresh row while
                    # later rows still overlap persisted history
                    self._ensure_loaded(part)
            prev_last = part.last_timestamp
            got = part.ingest_batch(tss[i:j], [c[i:j] for c in cols])
            if got:
                n += got
                self._resident += got
                last = part.last_timestamp
                if last is not None:
                    self.index.update_end_time(part.part_id, last)
                    if prev_last is None:
                        # partition enters the min-set: its last joins
                        # the min directly; a first row at/below the
                        # watermark is a BACKFILL into settled time
                        # (the run min, not the last — an entrant
                        # spanning the watermark still dirties the
                        # steps its early rows land on)
                        if self.ingest_watermark_ms >= 0:
                            if int(tss[i:j].min()) \
                                    <= self.ingest_watermark_ms:
                                self.ingest_backfill_epoch += 1
                            if last < self.ingest_watermark_ms:
                                self.ingest_watermark_ms = int(last)
                        else:
                            # first contribution ever (or only shells
                            # so far): fold in everything once
                            wm_recompute = True
                    elif prev_last <= self.ingest_watermark_ms:
                        # the min-set's laggard advanced: the min may
                        # rise — recompute once per container
                        wm_recompute = True
            self.stats.out_of_order_dropped += (j - i) - got
        if wm_recompute:
            self.ingest_watermark_ms = self._compute_watermark()
        self.stats.rows_ingested += n
        if offset >= 0:
            # conservative: record offset against all groups on explicit flush
            self._last_offset = offset
        return n

    def group_of(self, part_id: int) -> int:
        return part_id % self.num_groups

    def flush_group(self, group: int, offset: int = -1) -> int:
        """Encode write buffers of one flush group, persist new chunks +
        partkeys + the group checkpoint (TimeSeriesShard.scala:1341
        doFlushSteps: encode → ColumnStore.write → index/partkey write →
        writeCheckpoint).  Returns chunks written."""
        n = 0
        touched: List[TimeSeriesPartition] = []
        for pid, part in self.partitions.items():
            if pid % self.num_groups != group:
                continue
            info = part.switch_buffers()
            if info is not None:
                n += 1
                self.stats.chunks_encoded += 1
                self.stats.encoded_bytes += sum(len(v) for v in info.vectors)
            if self.column_store is not None \
                    and part.num_chunks > part.persisted_chunks:
                touched.append(part)
        if touched:
            from filodb_tpu_torch.store import PartKeyEntry
            entries = []
            for part in touched:
                new = part.chunks[part.persisted_chunks:]
                self.column_store.write_chunks(
                    self.ref.dataset, self.shard_num,
                    part.part_key.to_bytes(), new)
                part.persisted_chunks = part.num_chunks
                self.stats.chunks_persisted += len(new)
                entries.append(PartKeyEntry(
                    part.part_key.to_bytes(),
                    self.index.start_time(part.part_id)
                    or part.earliest_timestamp or 0,
                    part.last_timestamp or 0))
            self.column_store.write_part_keys(self.ref.dataset,
                                              self.shard_num, entries)
        self.stats.flushes_done += 1
        if self.flush_downsampler is not None:
            # persist pending ds records (also covers chunks encoded by
            # buffer-full switches during ingest since the last flush)
            self.flush_downsampler.flush()
        if offset >= 0:
            self.checkpoints[group] = offset
            if self.column_store is not None:
                self.column_store.write_checkpoint(
                    self.ref.dataset, self.shard_num, group, offset)
        return n

    def flush_all(self, offset: int = -1) -> int:
        return sum(self.flush_group(g, offset) for g in range(self.num_groups))

    def recovery_watermark(self) -> int:
        """min checkpoint over groups — replay start offset
        (IngestionActor.scala:297 doRecovery)."""
        if len(self.checkpoints) < self.num_groups:
            return -1
        return min(self.checkpoints.values())

    def _compute_watermark(self) -> int:
        """Exact settled-time bound: min over per-partition last
        timestamps. Evicted/bootstrapped ODP shells (in-memory chunks
        gone, ``last_timestamp`` None) contribute their persisted index
        end time — the page-in + OOO path guarantees a shell never
        re-ingests at/below it. Partitions that never ingested
        constrain nothing. O(partitions); runs on the ingest thread
        only when the min-set's laggard advanced (or membership
        changed), never per row."""
        lo = None
        for pid, p in self.partitions.items():
            t = p.last_timestamp
            if t is None and p.odp_pending:
                t = self.index.end_time(pid)
                if t == END_TIME_INGESTING:
                    t = None
            if t is not None and (lo is None or t < lo):
                lo = int(t)
        return -1 if lo is None else lo

    # -- persistence / recovery -------------------------------------------
    @publishes("watermark")
    def bootstrap_from_store(self) -> int:
        """Rebuild the tag index + partition shells from persisted partkeys
        and load checkpoint offsets (IndexBootstrapper.scala:43; recovery
        watermark read IngestionActor.scala:174). Chunk data stays in the
        store until a query or ingest pages it in (ODP)."""
        if self.column_store is None:
            return 0
        n = 0
        for e in self.column_store.scan_part_keys(self.ref.dataset,
                                                  self.shard_num):
            pk = PartKey.from_bytes(e.part_key)
            part = self.get_or_create_partition(pk, e.start_ts,
                                                active=False)
            if part is None:
                continue
            part.odp_pending = True
            self.index.update_end_time(part.part_id, e.end_ts)
            n += 1
        self.checkpoints = dict(self.column_store.read_checkpoints(
            self.ref.dataset, self.shard_num))
        self.stats.partitions_bootstrapped += n
        # shells joined the min-set via their persisted end times
        self.ingest_watermark_ms = self._compute_watermark()
        return n

    def _ensure_loaded(self, part: TimeSeriesPartition) -> None:
        """ODP read-through: page this partition's chunks back from the
        ColumnStore (OnDemandPagingShard.scala:26 /
        DemandPagedChunkStore.scala:34 — granularity here is the whole
        partition; chunks are append-only so the merge is a sorted concat)."""
        with self._odp_lock:
            if not part.odp_pending or self.column_store is None:
                part.odp_pending = False
                return
            loaded = self.column_store.read_chunks(
                self.ref.dataset, self.shard_num, part.part_key.to_bytes())
            # skip chunks already in memory (a shell that ingested + flushed
            # before page-in has persisted chunks present on both sides)
            have = {c.id for c in part.chunks}
            infos = [ChunkSetInfo(c.chunk_id, c.num_rows, c.start_ts,
                                  c.end_ts, c.vectors)
                     for c in loaded if c.chunk_id not in have]
            # prepending invalidates the decoded-prefix caches; swap the
            # list and clear them under the partition's cache lock so a
            # concurrent reader can't repopulate against the old prefix
            with part._cache_lock:
                part.chunks = infos + part.chunks
                part.persisted_chunks += len(infos)
                part._chunk_seq = max(part._chunk_seq, len(part.chunks))
                # bootstrapped shells never saw an ingest row: learn the
                # bucket scheme from the paged-in chunk header, before the
                # new epoch lets a selection record read it
                if infos and part._hist_scheme is None:
                    for ci, col in enumerate(part.schema.columns):
                        if col.col_type == ColumnType.HISTOGRAM:
                            part._hist_scheme = bh.hist_scheme_of(
                                infos[0].vectors[ci])
                            break
                part._page_epoch += 1
                part._drop_caches_locked()
            self._resident += sum(c.num_rows for c in infos)
            part.odp_pending = False
            self.stats.partitions_paged_in += 1

    # -- read path --------------------------------------------------------
    def lookup_partitions(self, filters: Sequence[ColumnFilter],
                          start_ts: int, end_ts: int
                          ) -> List[TimeSeriesPartition]:
        """(memstore lookupPartitions via the tag index; pages in evicted
        partitions read-through like OnDemandPagingShard)."""
        pids = self.index.part_ids_from_filters(filters, start_ts, end_ts)
        out = []
        for p in pids:
            part = self.partitions[p]
            if part.odp_pending:
                self._ensure_loaded(part)
            out.append(part)
        return out

    # -- eviction ---------------------------------------------------------
    def resident_samples(self) -> int:
        """Samples held in memory (encoded chunks + write buffers); ODP
        shells count 0 (their data lives in the ColumnStore). O(1):
        maintained by ingest/eviction/page-in, so the per-flush headroom
        check doesn't rescan every partition's chunk list."""
        return self._resident

    def recount_resident(self) -> int:
        """Full rescan (tests / forensic cross-check of the counter)."""
        n = 0
        for p in self.partitions.values():
            n += sum(c.num_rows for c in p.chunks) + p._buf_rows
        return n

    def decode_cache_bytes(self) -> int:
        """Total bytes in per-partition decode/merge caches (the
        ``filodb_decode_cache_bytes`` gauge — previously this memory was
        unbounded and invisible)."""
        return sum(p.cache_bytes() for p in list(self.partitions.values()))

    def trim_decode_caches(self, max_bytes: int) -> int:
        """Memory-bound the host decode/merge caches: when their total
        exceeds ``max_bytes``, release the caches of least-recently-
        written partitions whose chunks are all flushed/persisted (pure
        duplicates of immutable chunk bytes) until under budget. Runs on
        the ingest driver's flush path. Returns bytes freed."""
        if max_bytes <= 0:
            return 0
        total = self.decode_cache_bytes()
        if total <= max_bytes:
            return 0
        freed = 0
        parts = sorted(list(self.partitions.values()),
                       key=lambda p: p.last_timestamp or 0)
        for p in parts:
            if total - freed <= max_bytes:
                break
            freed += p.release_caches()
        return freed

    def ensure_headroom(self, max_samples: int,
                        headroom_pct: int = 25) -> int:
        """Memory-pressure eviction: when resident samples exceed the
        budget, evict the least-recently-written partitions until
        ``headroom_pct`` percent of the budget is free again
        (the reference's headroom task + PartitionEvictionPolicy
        watermark, TimeSeriesShard ensureFreeSpace /
        ensure-block-memory-headroom-percent). Requires a ColumnStore
        (eviction turns partitions into ODP shells) or drops series.
        Returns partitions evicted."""
        if max_samples <= 0:
            return 0
        cur = self.resident_samples()
        if cur <= max_samples:
            return 0
        target = max_samples * (100 - headroom_pct) // 100
        parts = sorted(
            ((p.last_timestamp, p) for p in self.partitions.values()
             if p.last_timestamp is not None and p.chunks
             and not p._buf_rows and not p.odp_pending),
            key=lambda x: x[0])
        freed = 0
        cutoff = None
        for last_ts, p in parts:
            if cur - freed <= target:
                break
            freed += sum(c.num_rows for c in p.chunks)
            cutoff = last_ts + 1
        if cutoff is None:
            return 0
        return self.evict_partitions(cutoff_ts=cutoff)

    @publishes("watermark")
    def evict_partitions(self, cutoff_ts: int) -> int:
        """Evict series whose data ended before cutoff
        (PartitionEvictionPolicy / EvictablePartIdQueueSet equivalents).

        With a ColumnStore the partition becomes an ODP shell: unpersisted
        chunks are written out first, memory is released, the index entry
        stays so queries can page the data back. Without one, the series is
        dropped entirely (memory-only deployments)."""
        evict = [
            pid for pid, p in self.partitions.items()
            if (p.last_timestamp is not None and p.last_timestamp < cutoff_ts
                and not p._buf_rows
                # shells that re-accumulated chunks (resumed ingest after
                # an earlier eviction) are evictable again; empty shells
                # have nothing to release
                and (p.chunks or not p.odp_pending))
        ]
        if self.column_store is not None:
            from filodb_tpu_torch.store import PartKeyEntry
            entries = []
            # hold the ODP lock for the persist+clear: a concurrent
            # _ensure_loaded page-in snapshotting chunks mid-eviction
            # could otherwise clear odp_pending with the just-evicted
            # chunks missing — silent permanent data loss until restart
            with self._odp_lock:
                for pid in evict:
                    part = self.partitions[pid]
                    new = part.chunks[part.persisted_chunks:]
                    if new:
                        self.column_store.write_chunks(
                            self.ref.dataset, self.shard_num,
                            part.part_key.to_bytes(), new)
                        self.stats.chunks_persisted += len(new)
                    entries.append(PartKeyEntry(
                        part.part_key.to_bytes(),
                        self.index.start_time(pid)
                        or part.earliest_timestamp or 0,
                        part.last_timestamp or 0))
                    self._resident -= sum(c.num_rows for c in part.chunks)
                    with part._cache_lock:
                        # flag BEFORE clearing: a concurrent lookup must
                        # either see the data or see the page-in flag,
                        # never an empty unflagged partition
                        part.odp_pending = True
                        part.chunks = []
                        part.persisted_chunks = 0
                        part._page_epoch += 1
                        part._drop_caches_locked()
            if entries:
                self.column_store.write_part_keys(
                    self.ref.dataset, self.shard_num, entries)
            for pid in evict:       # ODP shells: still counted, inactive
                part = self.partitions[pid]
                if part.card_active:
                    part.card_active = False
                    if self.card_tracker is not None:
                        self.card_tracker.modify_count(
                            self.card_tracker.prefix_of(
                                part.part_key.label_map), 0, -1)
        else:
            for pid in evict:
                part = self.partitions.pop(pid)
                self._resident -= sum(c.num_rows for c in part.chunks) \
                    + part._buf_rows
                self._by_part_key.pop(part.part_key.to_bytes(), None)
                if self.card_tracker is not None:
                    self.card_tracker.modify_count(
                        self.card_tracker.prefix_of(part.part_key.label_map),
                        -1, -1 if part.card_active else 0)
            self.index.remove_part_keys(evict)
            self.stats.num_series = len(self.partitions)
        self.stats.partitions_evicted += len(evict)
        if evict:
            # ODP shells swap a live last for an equal persisted end
            # (min unchanged); dropped series LEAVE the min-set and the
            # min may rise — recompute either way (eviction is rare)
            self.ingest_watermark_ms = self._compute_watermark()
        return len(evict)


class TimeSeriesMemStore:
    """Top-level store: dataset -> shards (memstore/TimeSeriesMemStore.scala:26).
    """

    def __init__(self, schemas: Optional[Schemas] = None,
                 column_store: Optional[object] = None):
        from filodb_tpu_torch.core.schemas import DEFAULT_SCHEMAS
        self.schemas = schemas or DEFAULT_SCHEMAS
        self.column_store = column_store
        self._shards: Dict[DatasetRef, Dict[int, TimeSeriesShard]] = {}
        # the shard MAP (not the shards) is mutated from concurrent
        # adopt/release workers during elastic membership; reads stay
        # lock-free GIL-atomic lookups
        self._shards_lock = threading.Lock()

    def setup(self, ref: DatasetRef, shard_num: int, num_groups: int = 8,
              max_chunk_rows: int = DEFAULT_MAX_CHUNK_ROWS,
              bootstrap: bool = False,
              card_tracker: Optional[object] = None,
              flush_downsampler: Optional[object] = None
              ) -> TimeSeriesShard:
        """Create one shard; with ``bootstrap`` (and a column store) the tag
        index + checkpoints are recovered from persistence
        (TimeSeriesMemStore.scala setup + IndexBootstrapper on startup)."""
        shard = TimeSeriesShard(ref, self.schemas, shard_num, num_groups,
                                max_chunk_rows,
                                column_store=self.column_store,
                                card_tracker=card_tracker,
                                flush_downsampler=flush_downsampler)
        with self._shards_lock:
            shards = self._shards.setdefault(ref, {})
            if shard_num in shards:
                raise ValueError(
                    f"shard {shard_num} already set up for {ref}")
            shards[shard_num] = shard
        if bootstrap:
            shard.bootstrap_from_store()
        return shard

    def get_shard(self, ref: DatasetRef, shard_num: int) -> TimeSeriesShard:
        return self._shards[ref][shard_num]

    def remove_shard(self, ref: DatasetRef, shard_num: int) -> None:
        """Release a shard (elastic recovery hand-back: the adopter drops
        its copy when the original owner returns — ShardManager.scala
        stopShards semantics)."""
        with self._shards_lock:
            self._shards.get(ref, {}).pop(shard_num, None)

    def shards(self, ref: DatasetRef) -> List[TimeSeriesShard]:
        return [s for _, s in sorted(self._shards.get(ref, {}).items())]

    def ingest(self, ref: DatasetRef, shard_num: int,
               container: RecordContainer, offset: int = -1) -> int:
        return self.get_shard(ref, shard_num).ingest(container, offset)

    def flush_all(self, ref: DatasetRef) -> int:
        return sum(s.flush_all() for s in self.shards(ref))

    def lookup_partitions(self, ref: DatasetRef, shard_num: int,
                          filters: Sequence[ColumnFilter],
                          start_ts: int, end_ts: int):
        return self.get_shard(ref, shard_num).lookup_partitions(
            filters, start_ts, end_ts)
