"""Downsample-index migration job.

The chunk downsampler (downsample/job.py) writes ds chunks + the part
keys it touched, but a series whose retention/lifecycle changed between
downsampler runs (stopped publishing, restarted later) leaves the
downsample datasets' part-key index stale. This job syncs raw part-key
index updates into every downsample dataset's index, mapping each
schema to its declared downsample schema — the reference runs this as
its own Spark job
(spark-jobs/src/main/scala/filodb/downsampler/index/DSIndexJob.scala:
migrateWithDownsamplePartKeys, updated-in-window partkeys from the raw
index upserted into the downsample Cassandra index)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence

from filodb_tpu_torch.core.record import PartKey
from filodb_tpu_torch.core.schemas import DEFAULT_SCHEMAS, Schemas
from filodb_tpu_torch.downsample.job import ds_dataset
from filodb_tpu_torch.store import PartKeyEntry


@dataclass
class DSIndexStats:
    scanned: int = 0
    migrated: int = 0
    skipped_schemas: Dict[str, int] = field(default_factory=dict)


class DSIndexJob:
    """Sync raw part-key index updates into the downsample datasets."""

    def __init__(self, column_store, schemas: Optional[Schemas] = None,
                 resolutions: Sequence[int] = (300_000, 3_600_000)):
        self.store = column_store
        self.schemas = schemas or DEFAULT_SCHEMAS
        self.resolutions = tuple(resolutions)

    def run(self, dataset: str, shard: int,
            updated_since_ms: int = 0) -> DSIndexStats:
        """Migrate part keys whose end time moved at/after
        ``updated_since_ms`` (0 = full sync)."""
        stats = DSIndexStats()
        out: Dict[str, list] = {ds_dataset(dataset, res): []
                                for res in self.resolutions}
        for e in self.store.scan_part_keys(dataset, shard):
            stats.scanned += 1
            if e.end_ts < updated_since_ms:
                continue
            pk = PartKey.from_bytes(e.part_key)
            schema = self.schemas.by_id(pk.schema_id)
            ds_name = schema.downsample_schema
            if not schema.downsamplers or not ds_name:
                stats.skipped_schemas[schema.name] = \
                    stats.skipped_schemas.get(schema.name, 0) + 1
                continue
            ds_schema = self.schemas.by_name(ds_name)
            ds_pk = PartKey(ds_schema.schema_id, pk.labels).to_bytes()
            for name in out:
                out[name].append(PartKeyEntry(ds_pk, e.start_ts,
                                              e.end_ts))
            stats.migrated += 1
        for name, entries in out.items():
            self.store.write_part_keys(name, shard, entries)
        return stats
