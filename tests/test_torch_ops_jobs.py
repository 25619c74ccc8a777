"""Operational batch jobs in the port against the JAX package:
downsample-index migration, the cross-store chunk copier with its
bit-level validation, and the cardinality buster, each run by both
packages on the same rows in stores of their own.

(Parity model: spark-jobs index/DSIndexJob.scala,
repair/ChunkCopier.scala:25, cardbuster/CardinalityBuster.scala.) Both
packages write the flat-file column store, so the encoded chunks and the
part-key entries are compared byte for byte."""

import pytest

from filodb_tpu.core.index import ColumnFilter as JFilter
from filodb_tpu.core.memstore import TimeSeriesShard as JShard
from filodb_tpu.core.record import RecordBuilder as JBuilder
from filodb_tpu.core.schemas import DEFAULT_SCHEMAS as J_SCHEMAS
from filodb_tpu.core.schemas import DatasetRef as JRef
from filodb_tpu.jobs import CardBuster as JBuster
from filodb_tpu.jobs import ChunkCopier as JCopier
from filodb_tpu.jobs import DSIndexJob as JIndexJob
from filodb_tpu.store import FlatFileColumnStore as JStore
from filodb_tpu_torch.core.index import ColumnFilter
from filodb_tpu_torch.core.memstore import ChunkSetInfo, TimeSeriesShard
from filodb_tpu_torch.core.record import PartKey, RecordBuilder
from filodb_tpu_torch.core.schemas import DEFAULT_SCHEMAS, DatasetRef
from filodb_tpu_torch.downsample.job import ds_dataset
from filodb_tpu_torch.jobs import (CardBuster, ChunkCopier,
                                   ChunkCopierStats, DSIndexJob)
from filodb_tpu_torch.store import FlatFileColumnStore

T0 = 1_600_000_000_000


def _populate(shard_cls, builder_cls, ref, schemas, store, n_series=6):
    shard = shard_cls(ref, schemas, 0, max_chunk_rows=50,
                      column_store=store)
    b = builder_cls(schemas)
    for s in range(n_series):
        labels = {"_metric_": "reqs_total", "_ws_": "demo",
                  "_ns_": "App-0", "instance": f"i{s}"}
        v = 0.0
        for t in range(120):
            v += float(s + 1)
            b.add_sample("prom-counter", labels, T0 + t * 10_000, v)
    for c in b.containers():
        shard.ingest(c)
    shard.flush_all()
    return shard


def _both(tmp_path, *names):
    """{name: (port store, JAX store)}, each populated with the rows."""
    out = {}
    for n in names:
        p = FlatFileColumnStore(str(tmp_path / f"port-{n}"))
        j = JStore(str(tmp_path / f"jax-{n}"))
        if n == "src":
            _populate(TimeSeriesShard, RecordBuilder,
                      DatasetRef("timeseries"), DEFAULT_SCHEMAS, p)
            _populate(JShard, JBuilder, JRef("timeseries"), J_SCHEMAS, j)
        out[n] = (p, j)
    return out


def _pk_entries(store, dataset):
    return sorted((e.part_key, e.start_ts, e.end_ts)
                  for e in store.scan_part_keys(dataset, 0))


def _chunks(store, dataset):
    return {e.part_key: [(c.chunk_id, c.num_rows, c.vectors)
                         for c in store.read_chunks(dataset, 0, e.part_key)]
            for e in store.scan_part_keys(dataset, 0)}


def test_ds_index_migration(tmp_path):
    s = _both(tmp_path, "src")
    store, jstore = s["src"]
    assert _pk_entries(store, "timeseries") == \
        _pk_entries(jstore, "timeseries")
    stats = DSIndexJob(store).run("timeseries", 0)
    jstats = JIndexJob(jstore).run("timeseries", 0)
    assert (stats.scanned, stats.migrated, stats.skipped_schemas) == \
        (jstats.scanned, jstats.migrated, jstats.skipped_schemas) == \
        (6, 6, {})
    for res in (300_000, 3_600_000):
        name = ds_dataset("timeseries", res)
        entries = _pk_entries(store, name)
        assert len(entries) == 6 and entries == _pk_entries(jstore, name)
        for pk_bytes, start, end in entries:
            pk = PartKey.from_bytes(pk_bytes)
            assert DEFAULT_SCHEMAS.by_id(pk.schema_id).name == \
                DEFAULT_SCHEMAS.by_name("prom-counter").downsample_schema
            assert start <= end
            assert dict(pk.labels)["_metric_"] == "reqs_total"
    # incremental run with a future watermark migrates nothing new
    later = T0 + 10_000_000_000
    assert DSIndexJob(store).run("timeseries", 0,
                                 updated_since_ms=later).migrated == 0 \
        == JIndexJob(jstore).run("timeseries", 0,
                                 updated_since_ms=later).migrated


def test_chunk_copier_bit_identical(tmp_path):
    s = _both(tmp_path, "src", "dst")
    (src, jsrc), (dst, jdst) = s["src"], s["dst"]
    copier, jcopier = ChunkCopier(src, dst), JCopier(jsrc, jdst)
    assert len(copier.diff("timeseries", 0)) == 6 == \
        len(jcopier.diff("timeseries", 0))
    stats = copier.run("timeseries", 0)
    jstats = jcopier.run("timeseries", 0)
    assert vars(stats) == vars(jstats)
    assert stats.part_keys == 6 and stats.chunks_copied > 0
    assert stats.validation_failures == 0
    assert stats.chunks_validated == stats.chunks_copied
    assert copier.diff("timeseries", 0) == []
    # bit-identical within each package, and across them: both write the
    # same flat-file records from the same rows
    assert _chunks(dst, "timeseries") == _chunks(src, "timeseries") \
        == _chunks(jdst, "timeseries")


def test_chunk_copier_detects_corruption(tmp_path):
    s = _both(tmp_path, "src", "dst")
    (src, _), (dst, _) = s["src"], s["dst"]
    copier = ChunkCopier(src, dst)
    copier.run("timeseries", 0, validate=False)
    # overwrite one target chunk with corrupted vectors (upsert-by-append:
    # the bad record wins the dedupe)
    e = next(iter(src.scan_part_keys("timeseries", 0)))
    chunks = dst.read_chunks("timeseries", 0, e.part_key)
    bad = ChunkSetInfo(chunks[0].chunk_id, chunks[0].num_rows,
                       chunks[0].start_ts, chunks[0].end_ts,
                       tuple(v + b"x" for v in chunks[0].vectors))
    dst.write_chunks("timeseries", 0, e.part_key, [bad])
    stats = ChunkCopierStats()
    copier._validate("timeseries", "timeseries", 0, 0, 1 << 62, stats)
    assert stats.validation_failures == 1
    assert stats.chunks_validated == \
        sum(len(v) for v in _chunks(src, "timeseries").values()) - 1


def test_cardbuster_deletes_matching_series(tmp_path):
    s = _both(tmp_path, "src")
    store, jstore = s["src"]
    buster, jbuster = CardBuster(store), JBuster(jstore)
    f, jf = ColumnFilter.regex("instance", "i[01]"), \
        JFilter.regex("instance", "i[01]")
    dry = buster.run("timeseries", 0, [f], dry_run=True)
    assert dry.deleted == 2 == jbuster.run("timeseries", 0, [jf],
                                           dry_run=True).deleted
    assert len(list(store.scan_part_keys("timeseries", 0))) == 6
    stats = buster.run("timeseries", 0, [f])
    jstats = jbuster.run("timeseries", 0, [jf])
    assert vars(stats) == vars(jstats) == {"scanned": 6, "deleted": 2}
    left = list(store.scan_part_keys("timeseries", 0))
    assert len(left) == 4
    assert _pk_entries(store, "timeseries") == \
        _pk_entries(jstore, "timeseries")
    for e in left:
        inst = PartKey.from_bytes(e.part_key).label_map["instance"]
        assert inst not in ("i0", "i1")
        chunks = store.read_chunks("timeseries", 0, e.part_key)
        assert chunks and all(c.vectors for c in chunks)
    with pytest.raises(ValueError):
        buster.run("timeseries", 0, [])
