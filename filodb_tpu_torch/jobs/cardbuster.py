"""Cardinality buster: bulk-delete part keys (and their chunks) that
match label filters from a persisted shard — the cleanup tool for
cardinality explosions the reference ships as
spark-jobs/src/main/scala/filodb/cardbuster/CardinalityBuster.scala
(delete-by-filter over the index + chunks tables)."""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Optional, Sequence

from filodb_tpu_torch.core.index import ColumnFilter
from filodb_tpu_torch.core.record import PartKey


def _match(f: ColumnFilter, v: str) -> bool:
    if f.op == "eq":
        return v == f.value
    if f.op == "neq":
        return v != f.value
    if f.op == "in":
        return v in f.value
    if f.op == "nin":
        return v not in f.value
    if f.op == "re":
        return re.fullmatch(f.value, v) is not None
    if f.op == "nre":
        return re.fullmatch(f.value, v) is None
    if f.op == "prefix":
        return v.startswith(f.value)
    return False


@dataclass
class CardBusterStats:
    scanned: int = 0
    deleted: int = 0


class CardBuster:
    """Delete persisted series whose labels match ALL given filters."""

    def __init__(self, column_store):
        self.store = column_store

    def run(self, dataset: str, shard: int,
            filters: Sequence[ColumnFilter],
            start_ms: Optional[int] = None,
            end_ms: Optional[int] = None,
            dry_run: bool = False) -> CardBusterStats:
        """Filters must be non-empty (an empty filter set would wipe the
        shard — the reference requires explicit delete filters too)."""
        if not filters:
            raise ValueError("cardbuster requires at least one filter")
        stats = CardBusterStats()
        doomed = []
        for e in self.store.scan_part_keys(dataset, shard):
            stats.scanned += 1
            if start_ms is not None and e.end_ts < start_ms:
                continue
            if end_ms is not None and e.start_ts > end_ms:
                continue
            labels = PartKey.from_bytes(e.part_key).label_map
            if all(_match(f, labels.get(f.label, "")) for f in filters):
                doomed.append(e.part_key)
        if doomed and not dry_run:
            self.store.delete_part_keys(dataset, shard, doomed)
        stats.deleted = len(doomed)
        return stats
