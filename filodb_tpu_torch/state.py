"""Carrying state across: build the port's device tiles and memstore from
plain numpy arrays, so that the port and the JAX package can be given
identical state (for a database this takes the place of loading weights).

  * ``tiles_from_numpy`` builds an ``AlignedTiles`` from the same arrays
    ``filodb_tpu.query.tilestore.AlignedTiles`` takes;
  * ``load_series`` fills a ``TimeSeriesShard`` from ``(labels, ts, values)``
    rows, flushed into chunks or left in the write buffer;
  * ``load_into_store`` routes such rows to the shards of a
    ``TimeSeriesMemStore`` the way the reference's ingest edge routes them,
    then loads each shard as ``load_series`` does.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Sequence, Tuple

import numpy as np

from filodb_tpu_torch.core.memstore import TimeSeriesMemStore, TimeSeriesShard
from filodb_tpu_torch.core.record import (PartKey, RecordContainer,
                                          ingestion_shard)
from filodb_tpu_torch.core.schemas import DatasetRef, PartitionSchema
from filodb_tpu_torch.query.tilestore import AlignedTiles


def tiles_from_numpy(keys: List[Dict[str, str]], base_ms: int, dt_ms: int,
                     valid: np.ndarray, ts_true: np.ndarray,
                     vals: np.ndarray, device=None) -> AlignedTiles:
    """[S, N] validity / true-timestamp (f64 ms) / value arrays -> device
    tiles on ``device`` (CUDA unless named)."""
    return AlignedTiles(keys, base_ms, dt_ms, np.asarray(valid, bool),
                        np.asarray(ts_true, np.float64),
                        np.asarray(vals, np.float64), device=device)


def load_series(shard: TimeSeriesShard,
                series: Sequence[Tuple[Mapping[str, str], np.ndarray,
                                       np.ndarray]],
                schema: str = "prom-counter", flush: bool = True) -> int:
    """Ingest ``(labels, ts ms, values)`` rows into ``shard`` as one record
    container (one same-partition run per series), then flush every group
    into chunks when ``flush`` is set; otherwise the rows stay in the write
    buffers (the live tail). Returns rows ingested."""
    sch = shard.schemas.by_name(schema)
    cont = RecordContainer(sch)
    ts_parts, val_parts, runs = [], [], []
    pos = 0
    for labels, ts, vals in series:
        ts = np.asarray(ts, np.int64)
        n = ts.size
        if n == 0:
            continue
        pk = PartKey(sch.schema_id, tuple(sorted(labels.items())))
        runs.append([pos, pos + n, pk])
        ts_parts.append(ts)
        val_parts.append(np.asarray(vals, np.float64))
        pos += n
    if not runs:
        return 0
    # columnar container: arrays in place of per-row lists (the ingest loop
    # reads only arrays() and runs())
    cont.timestamps = np.concatenate(ts_parts)
    cont.columns = [np.concatenate(val_parts)]
    cont._runs = runs
    n = shard.ingest(cont)
    if flush:
        shard.flush_all()
    return n


def load_into_store(store: TimeSeriesMemStore, ref: DatasetRef,
                    rows: Sequence[Tuple[Mapping[str, str], np.ndarray,
                                         np.ndarray]],
                    schema: str = "prom-counter", flush: bool = True,
                    num_shards: int = 4, spread: int = 1) -> int:
    """Route each ``(labels, ts ms, values)`` row to its shard by
    ``ingestion_shard(shard key hash, part hash, spread, num_shards)`` (the
    reference's routing, gateway/producer.py's ``shard_for``), then load
    each shard's rows with :func:`load_series`. Returns rows ingested."""
    part_schema = PartitionSchema()
    data_schema = store.schemas.by_name(schema)
    by_shard: Dict[int, list] = {}
    for labels, ts, vals in rows:
        pk = PartKey.make(data_schema, labels)
        shard = ingestion_shard(pk.shard_key_hash(part_schema),
                                pk.part_hash(), spread, num_shards)
        by_shard.setdefault(shard, []).append((labels, ts, vals))
    return sum(load_series(store.get_shard(ref, shard), part, schema, flush)
               for shard, part in sorted(by_shard.items()))
