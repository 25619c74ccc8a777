"""Flush-time downsample emission: ds records produced as chunks encode
(the counterpart of ``filodb_tpu.downsample.flush``).

(core/downsample/ShardDownsampler.scala:40,62
populateDownsampleRecords — when enabled, every flushed chunkset also
emits downsample records for each resolution, so the ds tier is
continuously fresh without waiting for the batch job. Like the
reference, records are per (chunk, period): a period spanning two chunks
yields two partial rows at distinct timestamps, which window aggregation
over nested periods combines exactly for sum/count/min/max.)
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from filodb_tpu_torch.core.record import PartKey
from filodb_tpu_torch.core.schemas import ColumnType, DatasetRef, Schemas
from filodb_tpu_torch.downsample.job import columnar_container, ds_dataset
from filodb_tpu_torch.memory import vectors as bv


class FlushDownsampler:
    """Per-shard flush-time downsampler writing into the derived
    ``<dataset>_ds_<res>`` datasets of the same ColumnStore.

    downsample/job.py computes the same per-period semantics with device
    functions for whole-history batches; this host path handles one small
    chunk at a time. tests/test_torch_flush_downsample.py and
    tests/test_torch_downsample.py pin both to the same raw-parity
    answers, so a semantic change to one that misses the other fails."""

    def __init__(self, column_store, dataset: str, shard_num: int,
                 schemas: Schemas,
                 resolutions: Sequence[int] = (300_000,)):
        from filodb_tpu_torch.core.memstore import TimeSeriesShard
        self._shard_cls = TimeSeriesShard
        self.store = column_store
        self.dataset = dataset
        self.shard_num = shard_num
        self.schemas = schemas
        self.resolutions = tuple(resolutions)
        self._out: Dict[str, object] = {}
        self.samples_emitted = 0

    def _out_shard(self, name: str):
        sh = self._out.get(name)
        if sh is None:
            sh = self._shard_cls(DatasetRef(name), self.schemas,
                                 self.shard_num,
                                 column_store=self.store)
            # recover per-series end times: crash-recovery replay re-emits
            # the same ds rows and the OOO guard drops them — the same
            # idempotency story as the raw tier
            sh.bootstrap_from_store()
            self._out[name] = sh
        return sh

    # -- emission ---------------------------------------------------------
    def on_chunk(self, part_key: PartKey, schema, info) -> None:
        """Downsample one freshly-encoded chunkset
        (populateDownsampleRecords per-chunk semantics)."""
        if not schema.downsamplers:
            return
        vci = schema.value_column_index()
        if schema.columns[vci].col_type == ColumnType.HISTOGRAM:
            return      # histograms: batch job (hLast) covers them
        ts = bv.decode_longs(info.vectors[0])
        vals = bv.decode_doubles(info.vectors[vci])
        marker = schema.downsample_period_marker
        for res in self.resolutions:
            if marker.startswith("counter"):
                self._emit_counter(part_key, schema, ts, vals, res)
            else:
                self._emit_gauge(part_key, ts, vals, res)

    def _emit_gauge(self, pk: PartKey, ts, vals, res: int) -> None:
        ds_schema = self.schemas.by_name("ds-gauge")
        base = (int(ts[0]) // res) * res
        period = (ts - base) // res
        nper = int(period[-1]) + 1
        cnt = np.bincount(period, minlength=nper)
        s = np.bincount(period, weights=vals, minlength=nper)
        mins = np.full(nper, np.inf)
        maxs = np.full(nper, -np.inf)
        np.minimum.at(mins, period, vals)
        np.maximum.at(maxs, period, vals)
        last_ts = np.zeros(nper, dtype=np.int64)
        last_ts[period] = ts            # sorted: last write wins
        out = self._out_shard(ds_dataset(self.dataset, res))
        out_pk = PartKey(ds_schema.schema_id, pk.labels)
        p = np.nonzero(cnt)[0]
        c = cnt[p].astype(np.float64)
        out.ingest(columnar_container(ds_schema, [(
            out_pk, last_ts[p], (mins[p], maxs[p], s[p], c, s[p] / c))]))
        self.samples_emitted += int(p.size)

    def _emit_counter(self, pk: PartKey, schema, ts, vals, res: int
                      ) -> None:
        """Boundary-sample preservation (first/last per period + drops),
        the counter downsampling scheme (ChunkDownsampler dLast +
        counter period marker)."""
        base = (int(ts[0]) // res) * res
        period = (ts - base) // res
        keep = np.zeros(ts.size, dtype=bool)
        keep[0] = True
        keep[np.nonzero(np.diff(period))[0]] = True       # period lasts
        keep[np.nonzero(np.diff(period))[0] + 1] = True   # period firsts
        keep[-1] = True
        drops = np.nonzero(np.diff(vals) < 0)[0]
        keep[drops] = True                                # pre-drop peak
        keep[drops + 1] = True                            # post-drop
        ds_name = schema.downsample_schema or schema.name
        ds_schema = self.schemas.by_name(ds_name)
        out = self._out_shard(ds_dataset(self.dataset, res))
        out_pk = PartKey(ds_schema.schema_id, pk.labels)
        out.ingest(columnar_container(ds_schema, [(
            out_pk, ts[keep], (vals[keep],))]))
        self.samples_emitted += int(keep.sum())

    # -- persistence ------------------------------------------------------
    def flush(self) -> None:
        """Persist emitted ds chunks (called after the raw flush group),
        then release them from memory — the ds tier is READ from the
        ColumnStore (DownsampledTimeSeriesStore pages it in), so keeping
        a second in-memory copy would only grow without bound."""
        for sh in self._out.values():
            sh.flush_all()
            sh.evict_partitions(cutoff_ts=1 << 62)
