"""Ingest records and partition keys.

TPU-native analogue of BinaryRecord v2
(core/src/main/scala/filodb.core/binaryrecord2/RecordBuilder.scala:34,
RecordSchema.scala:47, RecordContainer.scala).  The reference's format exists
to avoid JVM serialization; here the equivalent "zero-copy to the engine" goal
is met by columnar numpy batches (``RecordContainer`` below), while partition
keys keep a canonical binary form for persistence and index bootstrap.

**Hash compatibility is preserved exactly** — shard routing must agree with
the reference cluster (RecordBuilder.scala:638 combineHash, :667 shardKeyHash;
ShardMapper.scala:122 ingestionShard), pinned by tests.
"""

from __future__ import annotations

import functools
import struct
from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from filodb_tpu_torch.core.schemas import DataSchema, PartitionSchema, Schemas
from filodb_tpu_torch.lint.locks import single_writer
from filodb_tpu_torch.utils.xxhash import to_signed32, xxhash32

_M32 = 0xFFFFFFFF


@functools.lru_cache(maxsize=1 << 16)
def _str_hash(s: str) -> int:
    """xxhash32 of a label key or value: the ingest edge hashes the same
    few strings (metric, shard key, tag names, series) on every line."""
    return xxhash32(s.encode())


def combine_hash(h1: int, h2: int) -> int:
    """31*h1 + h2 with Java Int overflow (RecordBuilder.scala:638)."""
    return to_signed32(31 * (h1 & _M32) + (h2 & _M32))


def shard_key_hash(shard_key_values: Sequence[str], metric: str,
                   include_metric: bool = True) -> int:
    """Hash of the shard-key label *values* in key-name order, then the metric
    (RecordBuilder.scala:667-683)."""
    h = 7
    for v in shard_key_values:
        h = combine_hash(h, _str_hash(v))
    if include_metric:
        h = combine_hash(h, _str_hash(metric))
    return h


def sort_and_compute_hashes(pairs: Sequence[Tuple[str, str]]) -> Tuple[
        List[Tuple[str, str]], List[int]]:
    """Sort label pairs by key and hash each (RecordBuilder.scala:618)."""
    spairs = sorted(pairs, key=lambda kv: kv[0])
    hashes = [
        combine_hash(_str_hash(k), _str_hash(v))
        for k, v in spairs
    ]
    return spairs, hashes


def combine_hash_excluding(sorted_pairs: Sequence[Tuple[str, str]],
                           hashes: Sequence[int],
                           exclude_keys) -> int:
    """(RecordBuilder.scala:648 combineHashExcluding)."""
    h = 7
    for (k, _), kh in zip(sorted_pairs, hashes):
        if k not in exclude_keys:
            h = combine_hash(h, kh)
    return h


def partition_key_hash(labels: Mapping[str, str]) -> int:
    """Full partition hash over ALL labels, used with shardKeyHash to pick the
    ingestion shard (RecordBuilder partKeyHash semantics)."""
    spairs, hashes = sort_and_compute_hashes(list(labels.items()))
    return combine_hash_excluding(spairs, hashes, frozenset())


def ingestion_shard(shard_key_h: int, partition_h: int, spread: int,
                    num_shards: int) -> int:
    """Shard selection (coordinator/ShardMapper.scala:122): lower
    (log2NumShards - spread) bits from the shard-key hash, upper ``spread``
    bits from the partition hash."""
    log2 = num_shards.bit_length() - 1
    if (1 << log2) != num_shards:
        raise ValueError("num_shards must be a power of 2")
    if not 0 <= spread <= log2:
        raise ValueError(f"invalid spread {spread} for {num_shards} shards")
    shard_mask = (1 << (log2 - spread)) - 1
    part_mask = ((1 << log2) - 1) & ~shard_mask
    return (shard_key_h & shard_mask) | (partition_h & part_mask)


def query_shards(shard_key_h: int, spread: int, num_shards: int) -> List[int]:
    """All shards that may hold a shard key (ShardMapper.scala:93)."""
    log2 = num_shards.bit_length() - 1
    shard_mask = (1 << (log2 - spread)) - 1
    base = shard_key_h & shard_mask
    spacing = 1 << (log2 - spread)
    return list(range(base, num_shards, spacing))


# ---------------------------------------------------------------------------
# Partition key
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class PartKey:
    """One time series identity: schema + full label set
    (binaryrecord2 partition key; schemaID embedded per Schemas.scala).

    ``labels`` includes the metric label (default ``_metric_``) and shard-key
    labels (``_ws_``, ``_ns_``)."""
    schema_id: int
    labels: Tuple[Tuple[str, str], ...]  # sorted by key

    @staticmethod
    def make(schema: DataSchema, labels: Mapping[str, str]) -> "PartKey":
        return PartKey(schema.schema_id, tuple(sorted(labels.items())))

    @property
    def label_map(self) -> Dict[str, str]:
        return dict(self.labels)

    def metric(self, part_schema: PartitionSchema) -> str:
        return self.label_map.get(part_schema.metric_column, "")

    def shard_key_hash(self, part_schema: PartitionSchema) -> int:
        lm = self.label_map
        values = [lm.get(c, "") for c in part_schema.non_metric_shard_key_columns]
        return shard_key_hash(values, lm.get(part_schema.metric_column, ""))

    def part_hash(self) -> int:
        return partition_key_hash(self.label_map)

    # Canonical binary form — persistence + index bootstrap interchange.
    # Layout: u16 schema_id, u16 numPairs, then per pair (u16 klen, bytes,
    # u16 vlen, bytes), UTF-8.
    def to_bytes(self) -> bytes:
        out = bytearray(struct.pack("<HH", self.schema_id, len(self.labels)))
        for k, v in self.labels:
            kb, vb = k.encode(), v.encode()
            out.extend(struct.pack("<H", len(kb)))
            out.extend(kb)
            out.extend(struct.pack("<H", len(vb)))
            out.extend(vb)
        return bytes(out)

    @staticmethod
    def from_bytes(buf: bytes) -> "PartKey":
        schema_id, npairs = struct.unpack_from("<HH", buf, 0)
        off = 4
        pairs = []
        for _ in range(npairs):
            (klen,) = struct.unpack_from("<H", buf, off)
            off += 2
            k = buf[off : off + klen].decode()
            off += klen
            (vlen,) = struct.unpack_from("<H", buf, off)
            off += 2
            v = buf[off : off + vlen].decode()
            off += vlen
            pairs.append((k, v))
        return PartKey(schema_id, tuple(pairs))


# ---------------------------------------------------------------------------
# Ingest record containers (columnar batches)
# ---------------------------------------------------------------------------

@dataclass
class IngestRecord:
    """One sample: partkey + timestamp + data column values
    (BinaryRecordRowReader equivalent, RecordSchema.scala:625)."""
    part_key: PartKey
    timestamp: int
    values: Tuple  # data column values in schema order (floats / hist arrays)


@dataclass
class RecordContainer:
    """A batch of ingest records for one schema — the unit handed to the
    ingestion pipeline (RecordContainer.scala; Kafka payload unit).

    Columnar: one numpy array per column, plus per-row partkey references;
    this is the "zero-serialization" analogue — arrays flow straight into the
    write-buffer appenders. Same-partition runs are tracked AT ADD TIME
    (builders emit per-series bursts), so the shard ingest loop walks
    O(series) runs instead of O(rows) with per-row PartKey comparisons."""
    schema: DataSchema
    part_keys: List[PartKey] = field(default_factory=list)
    timestamps: List[int] = field(default_factory=list)
    columns: List[List] = field(default_factory=list)  # per data column
    _runs: List = field(default_factory=list)          # [start, end, pk]

    def __post_init__(self):
        if not self.columns:
            self.columns = [[] for _ in self.schema.data_columns]

    def add(self, part_key: PartKey, timestamp: int, *values) -> None:
        if len(values) != len(self.schema.data_columns):
            raise ValueError(
                f"expected {len(self.schema.data_columns)} values, "
                f"got {len(values)}")
        i = len(self.timestamps)
        if self._runs and (self._runs[-1][2] is part_key
                           or self._runs[-1][2] == part_key):
            self._runs[-1][1] = i + 1
        else:
            self._runs.append([i, i + 1, part_key])
        self.part_keys.append(part_key)
        self.timestamps.append(int(timestamp))
        for col, v in zip(self.columns, values):
            col.append(v)

    def arrays(self):
        """Columnar numpy view of the container: (ts int64 array,
        per-column float64 arrays — histogram columns stay per-row
        lists). Cached by row count; run slices of these are zero-copy
        views, so the per-run ingest cost is O(1)."""
        n = len(self.timestamps)
        cached = getattr(self, "_arrays_cache", None)
        if cached is not None and cached[0] == n:
            return cached[1], cached[2]
        ts = np.asarray(self.timestamps, dtype=np.int64)
        cols = []
        from filodb_tpu_torch.core.schemas import ColumnType  # cycle-free late
        for col, vals in zip(self.schema.data_columns, self.columns):
            if col.col_type in (ColumnType.HISTOGRAM, ColumnType.STRING):
                cols.append(vals)
            else:
                cols.append(np.asarray(vals, dtype=np.float64))
        self._arrays_cache = (n, ts, cols)
        return ts, cols

    def runs(self):
        """Consecutive same-partition [start, end, pk] runs. Recomputed
        lazily for containers assembled from raw lists (wire decode)."""
        if not self._runs and self.timestamps:
            runs = []
            pks = self.part_keys
            i, total = 0, len(pks)
            while i < total:
                j = i + 1
                pk = pks[i]
                while j < total and (pks[j] is pk or pks[j] == pk):
                    j += 1
                runs.append([i, j, pk])
                i = j
            self._runs = runs
        return self._runs

    def __len__(self) -> int:
        return len(self.timestamps)

    def rows(self):
        for i in range(len(self.timestamps)):
            yield IngestRecord(
                self.part_keys[i], self.timestamps[i],
                tuple(col[i] for col in self.columns))


@single_writer("a RecordBuilder is constructed, filled, and drained by "
               "ONE producer thread (a gateway handler, a selfmon "
               "tick); instances are never shared across threads")
class RecordBuilder:
    """Builds RecordContainers from label maps + samples, computing shard
    hashes (RecordBuilder.scala:34 public API surface).

    PartKeys are interned per builder: the same series yields the SAME
    object, so downstream run detection and partition-map lookups hit the
    identity fast path instead of re-hashing label tuples per row."""

    def __init__(self, schemas: Schemas):
        self.schemas = schemas
        self._containers: Dict[str, RecordContainer] = {}
        self._pk_intern: Dict[Tuple[int, Tuple], PartKey] = {}

    def add_sample(self, schema_name: str, labels: Mapping[str, str],
                   timestamp: int, *values) -> PartKey:
        schema = self.schemas.by_name(schema_name)
        key = (schema.schema_id, tuple(sorted(labels.items())))
        pk = self._pk_intern.get(key)
        if pk is None:
            pk = PartKey(key[0], key[1])
            self._pk_intern[key] = pk
        cont = self._containers.setdefault(schema_name, RecordContainer(schema))
        cont.add(pk, timestamp, *values)
        return pk

    def containers(self) -> List[RecordContainer]:
        out = [c for c in self._containers.values() if len(c)]
        self._containers = {}
        return out
