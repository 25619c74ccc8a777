"""Cross-store chunk copier / repair job.

Copies a dataset shard's part keys and (time-ranged) chunks from one
ColumnStore to another and validates the copy bit-for-bit — the DR
repair tool the reference runs as a Spark job
(spark-jobs/src/main/scala/filodb/repair/ChunkCopier.scala:25: Cassandra
token-range scan of the source chunks table, writes to the target
keyspace, used to backfill a replica cluster or repair corruption)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

from filodb_tpu_torch.core.memstore import ChunkSetInfo


@dataclass
class ChunkCopierStats:
    part_keys: int = 0
    chunks_copied: int = 0
    bytes_copied: int = 0
    chunks_validated: int = 0
    validation_failures: int = 0


class ChunkCopier:
    """Copy one shard of one dataset between two ColumnStores."""

    def __init__(self, source, target):
        self.source = source
        self.target = target

    def run(self, dataset: str, shard: int, start_ms: int = 0,
            end_ms: int = 1 << 62, target_dataset: str = None,
            validate: bool = True) -> ChunkCopierStats:
        stats = ChunkCopierStats()
        tds = target_dataset or dataset
        entries = list(self.source.scan_part_keys(dataset, shard))
        for e in entries:
            chunks = self.source.read_chunks(dataset, shard, e.part_key,
                                             start_ms, end_ms)
            if chunks:
                infos = [ChunkSetInfo(c.chunk_id, c.num_rows, c.start_ts,
                                      c.end_ts, c.vectors)
                         for c in chunks]
                self.target.write_chunks(tds, shard, e.part_key, infos)
                stats.chunks_copied += len(infos)
                stats.bytes_copied += sum(
                    sum(len(v) for v in c.vectors) for c in chunks)
            stats.part_keys += 1
        self.target.write_part_keys(tds, shard, entries)
        if validate:
            self._validate(dataset, tds, shard, start_ms, end_ms, stats)
        return stats

    def _validate(self, dataset: str, tds: str, shard: int,
                  start_ms: int, end_ms: int,
                  stats: ChunkCopierStats) -> None:
        """Re-read every copied chunk from the target and compare the
        encoded vectors byte-for-byte (the copier moves opaque encoded
        chunks; any divergence means corruption in flight)."""
        for e in self.source.scan_part_keys(dataset, shard):
            src = {c.chunk_id: c for c in self.source.read_chunks(
                dataset, shard, e.part_key, start_ms, end_ms)}
            dst = {c.chunk_id: c for c in self.target.read_chunks(
                tds, shard, e.part_key, start_ms, end_ms)}
            for cid, c in src.items():
                d = dst.get(cid)
                if d is None or d.vectors != c.vectors \
                        or d.num_rows != c.num_rows:
                    stats.validation_failures += 1
                else:
                    stats.chunks_validated += 1

    def diff(self, dataset: str, shard: int, start_ms: int = 0,
             end_ms: int = 1 << 62) -> List[bytes]:
        """Part keys whose chunk sets differ between the stores (repair
        planning: run diff first, copy only what's missing)."""
        out = []
        for e in self.source.scan_part_keys(dataset, shard):
            src = {c.chunk_id for c in self.source.read_chunks(
                dataset, shard, e.part_key, start_ms, end_ms)}
            dst = {c.chunk_id for c in self.target.read_chunks(
                dataset, shard, e.part_key, start_ms, end_ms)}
            if src - dst:
                out.append(e.part_key)
        return out
