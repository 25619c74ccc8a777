"""Downsampler batch job: persisted raw chunks -> multi-resolution ds chunks
(the counterpart of ``filodb_tpu.downsample.job``).

The reference runs this as a Spark job over Cassandra token-range splits
(spark-jobs/downsampler/chunk/DownsamplerMain.scala:69 ->
BatchDownsampler.downsampleBatch :119 -> downsamplePart :192: rebuild the
partition, mark periods, run ChunkDownsamplers per resolution, re-encode,
persist to the downsample keyspace).

Here: one process per shard, all per-period math as a few device ops per
[S, N] tile batch (downsample/kernels.py), the host decoding input chunks
and encoding output chunks. Output lands in the same ColumnStore under the
derived dataset ``<dataset>_ds_<res>`` with the schema's declared
downsample schema (gauge -> ds-gauge, prom-counter -> prom-counter), so
the ordinary query path (and the downsampled store's resolution selector)
reads it like any other dataset.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from filodb_tpu_torch.core.memstore import TimeSeriesShard
from filodb_tpu_torch.core.record import PartKey, RecordContainer
from filodb_tpu_torch.core.schemas import (DEFAULT_SCHEMAS, ColumnType,
                                           DatasetRef, Schemas)
from filodb_tpu_torch.downsample import kernels
from filodb_tpu_torch.lint.capacity import capacity
from filodb_tpu_torch.memory import vectors as bv
from filodb_tpu_torch.query.backend import _TS_PAD, _next_pow2
from filodb_tpu_torch.query.tilestore import resolve_device


def ds_dataset(dataset: str, res_ms: int) -> str:
    """Derived downsample dataset name (reference: separate downsample
    keyspace/cluster per resolution, DownsamplerSettings)."""
    return f"{dataset}_ds_{res_ms}"


@dataclass
class DownsampleStats:
    partitions_read: int = 0
    samples_read: int = 0
    samples_written: int = 0
    chunks_written: int = 0
    skipped_schemas: Dict[str, int] = field(default_factory=dict)


def columnar_container(schema, rows) -> RecordContainer:
    """One record container of ``schema`` from ``(part_key, ts [n],
    [per-data-column [n] arrays])`` rows, built as columns (the ingest
    loop reads only the container's arrays and same-partition runs)."""
    cont = RecordContainer(schema)
    runs, ts_parts = [], []
    cols = [[] for _ in schema.data_columns]
    pos = 0
    for pk, ts, values in rows:
        n = int(ts.size)
        if n == 0:
            continue
        runs.append([pos, pos + n, pk])
        ts_parts.append(np.asarray(ts, np.int64))
        for c, v in zip(cols, values):
            c.append(np.asarray(v, np.float64))
        pos += n
    if runs:
        cont.timestamps = np.concatenate(ts_parts)
        cont.columns = [np.concatenate(c) for c in cols]
        cont._runs = runs
    return cont


class DownsamplerJob:
    """Batch-downsample one shard of one dataset into all resolutions, the
    per-period math on ``device`` (CUDA unless named)."""

    def __init__(self, column_store, schemas: Optional[Schemas] = None,
                 resolutions: Sequence[int] = (300_000, 3_600_000),
                 batch_series: int = 256, device=None):
        self.store = column_store
        self.schemas = schemas or DEFAULT_SCHEMAS
        self.resolutions = tuple(resolutions)
        self.batch_series = batch_series
        self.device = resolve_device(device)

    # -- input ------------------------------------------------------------
    def _load_partitions(self, dataset: str, shard: int):
        """Decode every persisted partition's (ts, value-column) arrays.
        Yields (part_key, schema, ts, vals). For histogram schemas vals is
        a dict: {"cols": [per-double-column f64 arrays...],
        "hist": [n, nb] f64, "scheme": bucket scheme}."""
        for e in self.store.scan_part_keys(dataset, shard):
            pk = PartKey.from_bytes(e.part_key)
            schema = self.schemas.by_id(pk.schema_id)
            vci = schema.value_column_index()
            col = schema.columns[vci]
            if col.col_type == ColumnType.HISTOGRAM:
                got = self._load_hist_partition(dataset, shard, e, schema,
                                                vci)
                if got is not None:
                    yield pk, schema, got[0], got[1]
                else:
                    yield pk, schema, None, None      # counted as skipped
                continue
            ts_parts, val_parts = [], []
            for c in self.store.read_chunks(dataset, shard, e.part_key):
                ts_parts.append(bv.decode_longs(c.vectors[0]))
                val_parts.append(bv.decode_doubles(c.vectors[vci]))
            if not ts_parts:
                continue
            yield (pk, schema, np.concatenate(ts_parts),
                   np.concatenate(val_parts))

    def _load_hist_partition(self, dataset, shard, e, schema, vci):
        """All columns of a histogram partition: (ts, payload dict).
        Only the (ts, sum, count, h) shape is handled (prom-histogram /
        delta-histogram layout); wider schemas are skipped."""
        from filodb_tpu_torch.memory import histogram as bh
        dbl_idx = [i for i, c in enumerate(schema.columns)
                   if i != 0 and i != vci]
        if len(schema.columns) != 4 or len(dbl_idx) != 2:
            return None
        ts_parts, hist_parts, dbl_parts = [], [], [[] for _ in dbl_idx]
        scheme = None
        les = None
        for c in self.store.read_chunks(dataset, shard, e.part_key):
            ts_parts.append(bv.decode_longs(c.vectors[0]))
            sch, _, mat = bh.decode_histograms(c.vectors[vci])
            cur_les = sch.les()
            if scheme is None:
                scheme, les = sch, cur_les
            elif not np.array_equal(les, cur_les):
                return None     # bucket boundaries changed mid-history
            hist_parts.append(mat)
            for j, di in enumerate(dbl_idx):
                dbl_parts[j].append(bv.decode_doubles(c.vectors[di]))
        if not ts_parts or scheme is None:
            return None
        return (np.concatenate(ts_parts),
                {"cols": [np.concatenate(p) for p in dbl_parts],
                 "hist": np.concatenate(hist_parts, axis=0),
                 "scheme": scheme})

    # -- output -----------------------------------------------------------
    def _out_shard(self, out_shards: Dict[str, TimeSeriesShard],
                   dataset: str, res: int, shard: int) -> TimeSeriesShard:
        name = ds_dataset(dataset, res)
        sh = out_shards.get(name)
        if sh is None:
            sh = TimeSeriesShard(DatasetRef(name), self.schemas, shard,
                                 column_store=self.store)
            out_shards[name] = sh
        return sh

    # -- the job ----------------------------------------------------------
    def run(self, dataset: str, shard: int,
            start_ms: Optional[int] = None,
            end_ms: Optional[int] = None) -> DownsampleStats:
        stats = DownsampleStats()
        gauges: List[Tuple[PartKey, object, np.ndarray, np.ndarray]] = []
        counters: List[Tuple[PartKey, object, np.ndarray, np.ndarray]] = []
        hists: List[Tuple[PartKey, object, np.ndarray, dict]] = []
        for pk, schema, ts, vals in self._load_partitions(dataset, shard):
            if ts is None or not schema.downsamplers:
                stats.skipped_schemas[schema.name] = \
                    stats.skipped_schemas.get(schema.name, 0) + 1
                continue
            if start_ms is not None or end_ms is not None:
                lo = np.searchsorted(ts, start_ms or 0, side="left")
                hi = np.searchsorted(ts, end_ms or (1 << 62), side="right")
                ts = ts[lo:hi]
                if isinstance(vals, dict):
                    vals = {"cols": [c[lo:hi] for c in vals["cols"]],
                            "hist": vals["hist"][lo:hi],
                            "scheme": vals["scheme"]}
                else:
                    vals = vals[lo:hi]
            if not ts.size:
                continue
            stats.partitions_read += 1
            stats.samples_read += int(ts.size)
            marker = schema.downsample_period_marker
            if isinstance(vals, dict):
                hists.append((pk, schema, ts, vals))
            elif marker.startswith("counter"):
                counters.append((pk, schema, ts, vals))
            else:
                gauges.append((pk, schema, ts, vals))

        out_shards: Dict[str, TimeSeriesShard] = {}
        for batch in _batches(gauges, self.batch_series):
            self._downsample_gauge_batch(batch, dataset, shard,
                                         out_shards, stats)
        for res in self.resolutions:
            for batch in _batches(counters, self.batch_series):
                self._downsample_counter_batch(batch, dataset, shard, res,
                                               out_shards, stats)
            for item in hists:
                self._downsample_hist_partition(item, dataset, shard, res,
                                                out_shards, stats)
        for sh in out_shards.values():
            sh.flush_all()
        stats.chunks_written = sum(
            s.stats.chunks_persisted for s in out_shards.values())
        return stats

    @capacity(
        "downsample-pack-buffers", bytes_per_sample=16.0,
        reason="the padded batch staging block the downsample functions "
               "consume on the device is [S, pow2(maxlen)] int64 "
               "timestamps (8 B) + f64 values (8 B) = 16 B per padded "
               "slot, alive for one batch dispatch (the lens vector "
               "and period outputs are host-side)")
    def _pack(self, batch):
        S = len(batch)
        maxlen = max(ts.size for _, _, ts, _ in batch)
        N = _next_pow2(maxlen)
        ts_pad = np.full((S, N), _TS_PAD, dtype=np.int64)
        vals_pad = np.zeros((S, N), dtype=np.float64)
        lens = np.zeros(S, dtype=np.int32)
        t_lo, t_hi = None, None
        for i, (_, _, ts, vals) in enumerate(batch):
            m = ~np.isnan(vals)
            ts, vals = ts[m], vals[m]
            n = ts.size
            ts_pad[i, :n] = ts
            vals_pad[i, :n] = vals
            lens[i] = n
            if n:
                t_lo = int(ts[0]) if t_lo is None else min(t_lo, int(ts[0]))
                t_hi = int(ts[-1]) if t_hi is None else max(t_hi,
                                                            int(ts[-1]))
        return ts_pad, vals_pad, lens, t_lo, t_hi

    def _on_device(self, *arrays):
        return tuple(torch.from_numpy(a).to(self.device) for a in arrays)

    @staticmethod
    def _w_bound(ts_pad, lens, res) -> int:
        """Samples-per-period cap for the min/max gather."""
        d = np.diff(ts_pad, axis=1)
        valid = (np.arange(1, ts_pad.shape[1])[None, :] < lens[:, None])
        d = d[valid & (d > 0)]
        min_dt = int(d.min()) if d.size else res
        return min(_next_pow2(int(res // max(min_dt, 1)) + 2, 4),
                   max(int(ts_pad.shape[1]), 4))

    def _downsample_gauge_batch(self, batch, dataset, shard,
                                out_shards, stats) -> None:
        """All resolutions for one gauge batch: the finest level reads raw
        tiles, coarser levels cascade from the previous level (sum of sums,
        min of mins, ...), which keeps device work O(samples + periods)."""
        ts_pad, vals_pad, lens, t_lo, t_hi = self._pack(batch)
        if t_lo is None:
            return
        rc = kernels.regular_cadence(ts_pad, lens,
                                     int(min(self.resolutions)))
        d_ts, d_vals, d_lens = self._on_device(ts_pad, vals_pad, lens)
        prev = prev_res = prev_base = None
        for res in sorted(self.resolutions):
            base = (t_lo // res) * res
            nperiods = int((t_hi - base) // res) + 1
            if prev is not None and res % prev_res == 0 \
                    and (prev_base - base) % prev_res == 0:
                # coarser level from the finer one: aligned reshape when
                # the resolutions nest, gather cascade otherwise
                arrays = kernels.cascade_gauge_aligned(
                    prev, res // prev_res,
                    int((prev_base - base) // prev_res))
            else:
                arrays = None
                if rc is not None:
                    arrays = kernels.downsample_gauge_fast(
                        d_ts, d_vals, d_lens, base, res, nperiods,
                        cadence=rc)
                if arrays is None:
                    wb = self._w_bound(ts_pad, lens, res)
                    arrays = kernels.downsample_gauge_tiles(
                        d_ts, d_vals, d_lens, base, res, nperiods, wb)
            self._emit_gauge(batch, [a.cpu().numpy() for a in arrays],
                             dataset, res, shard, out_shards, stats)
            prev, prev_res, prev_base = arrays, res, base

    def _emit_gauge(self, batch, arrays, dataset, res, shard, out_shards,
                    stats) -> None:
        sums, cnts, mins, maxs, last_v, last_ts = arrays
        out = self._out_shard(out_shards, dataset, res, shard)
        ds_schema = self.schemas.by_name("ds-gauge")
        rows = []
        for i, (pk, schema, _, _) in enumerate(batch):
            has = cnts[i] > 0
            if not has.any():
                continue
            s, c = sums[i][has], cnts[i][has]
            rows.append((PartKey(ds_schema.schema_id, pk.labels),
                         last_ts[i][has],
                         (mins[i][has], maxs[i][has], s, c, s / c)))
            stats.samples_written += int(c.size)
        if rows:
            out.ingest(columnar_container(ds_schema, rows))

    def _downsample_counter_batch(self, batch, dataset, shard, res,
                                  out_shards, stats) -> None:
        ts_pad, vals_pad, lens, t_lo, t_hi = self._pack(batch)
        if t_lo is None:
            return
        base = (t_lo // res) * res
        nperiods = int((t_hi - base) // res) + 1
        mask = kernels.counter_emit_mask(
            *self._on_device(ts_pad, vals_pad, lens), base, res,
            nperiods).cpu().numpy()
        out = self._out_shard(out_shards, dataset, res, shard)
        by_schema: Dict[str, list] = {}
        for i, (pk, schema, _, _) in enumerate(batch):
            m = mask[i]
            if not m.any():
                continue
            ds_name = schema.downsample_schema or schema.name
            ds_schema = self.schemas.by_name(ds_name)
            by_schema.setdefault(ds_name, []).append(
                (PartKey(ds_schema.schema_id, pk.labels), ts_pad[i][m],
                 (vals_pad[i][m],)))
            stats.samples_written += int(m.sum())
        for ds_name, rows in by_schema.items():
            out.ingest(columnar_container(self.schemas.by_name(ds_name),
                                          rows))

    def _downsample_hist_partition(self, item, dataset, shard, res,
                                   out_shards, stats) -> None:
        """One histogram partition -> ds chunks at one resolution.

        Cumulative schemas (downsample-period-marker = counter(N), e.g.
        prom-histogram: hLast/dLast downsamplers) keep the period-boundary
        samples of every column, marked by counter dips of the count
        column, so rate() over the ds data sees the same increases. Delta
        schemas (time marker, hSum/dSum) sum every column per period
        (ChunkDownsampler.scala:38-353 HistSumDownsampler/LastValueHDowns)."""
        pk, schema, ts, payload = item
        sums, cnts = payload["cols"]
        hist, scheme = payload["hist"], payload["scheme"]
        marker = schema.downsample_period_marker
        base = (int(ts[0]) // res) * res
        nperiods = int((int(ts[-1]) - base) // res) + 1
        ds_name = schema.downsample_schema or schema.name
        ds_schema = self.schemas.by_name(ds_name)
        out = self._out_shard(out_shards, dataset, res, shard)
        cont = RecordContainer(ds_schema)
        out_pk = PartKey(ds_schema.schema_id, pk.labels)
        if marker.startswith("counter"):
            n = ts.size
            N = _next_pow2(n)
            ts_p = np.full(N, _TS_PAD, dtype=np.int64)
            ts_p[:n] = ts
            cn_p = np.zeros(N)
            cn_p[:n] = cnts
            mask = kernels.counter_emit_mask(
                *self._on_device(ts_p[None, :], cn_p[None, :],
                                 np.array([n], dtype=np.int32)),
                base, res, nperiods).cpu().numpy()[0][:n]
            for i in np.nonzero(mask)[0]:
                cont.add(out_pk, int(ts[i]), float(sums[i]), float(cnts[i]),
                         (scheme, hist[i].astype(np.int64)))
                stats.samples_written += 1
        else:
            period = np.clip((ts - base) // res, 0, nperiods - 1)
            pe_sum = np.zeros(nperiods)
            pe_cnt = np.zeros(nperiods)
            pe_hist = np.zeros((nperiods, hist.shape[1]))
            pe_n = np.bincount(period, minlength=nperiods)
            np.add.at(pe_sum, period, sums)
            np.add.at(pe_cnt, period, cnts)
            np.add.at(pe_hist, period, hist)
            last_ts = np.zeros(nperiods, dtype=np.int64)
            last_ts[period] = ts       # sorted: last write per period wins
            for p in np.nonzero(pe_n)[0]:
                cont.add(out_pk, int(last_ts[p]), float(pe_sum[p]),
                         float(pe_cnt[p]),
                         (scheme, pe_hist[p].astype(np.int64)))
                stats.samples_written += 1
        if len(cont):
            out.ingest(cont)


def _batches(items, size):
    for i in range(0, len(items), size):
        yield items[i:i + size]
