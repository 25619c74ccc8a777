"""Query execution engine (numpy oracle backend).

Materializes and evaluates LogicalPlans against a set of memstore shards.
This is the single-process analogue of the reference's ExecPlan pipeline
(query/exec/ExecPlan.scala:46, SelectRawPartitionsExec.scala:159,
PeriodicSamplesMapper.scala:61, AggrOverRangeVectors.scala:98,193,
BinaryJoinExec.scala:58, InstantVectorFunctionMapper, ScalarOperationMapper)
— re-shaped around dense [series, steps] grids instead of row iterators.

Every numeric here defines the oracle the TPU backend
(filodb_tpu_torch.query.tpu) must match bit-for-bit modulo float tolerance.
"""

from __future__ import annotations

import math
import re
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from filodb_tpu_torch.core.index import ColumnFilter
from filodb_tpu_torch.core.memstore import TimeSeriesShard
from filodb_tpu_torch.core.schemas import ColumnType
from filodb_tpu_torch.memory import histogram as bh
from filodb_tpu_torch.memory.vectors import counter_correction
from filodb_tpu_torch.obs import metrics as obs_metrics
from filodb_tpu_torch.obs import trace as obs_trace
from filodb_tpu_torch.query import logical as lp
from filodb_tpu_torch.query import rangefn as rf
from filodb_tpu_torch.query.model import (GridResult, QueryError, QueryLimits,
                                    QueryStats, RangeParams, RawSeries,
                                    ScalarResult, StaleRoutingError)


METRIC_LABELS = ("_metric_", "__name__")
# the functions of the slide evaluator and the group-sum kernel
_COUNTER_FUNCS = ("rate", "increase", "delta")


def strip_metric(labels: Mapping[str, str]) -> Dict[str, str]:
    return {k: v for k, v in labels.items() if k not in METRIC_LABELS}


# ---------------------------------------------------------------------------
# Raw data selection (SelectRawPartitionsExec)
# ---------------------------------------------------------------------------

def select_raw_series(shards: Sequence[TimeSeriesShard],
                      filters: Sequence[ColumnFilter],
                      start_ms: int, end_ms: int,
                      column: Optional[str] = None,
                      stats: Optional[QueryStats] = None,
                      full: bool = False,
                      limits: Optional[QueryLimits] = None,
                      deadline=None, margin_ms: int = 0) -> List[RawSeries]:
    """Gather raw samples for all matching series across shards
    (SelectRawPartitionsExec.scala:159 doExecute; schema resolved per
    partition like MultiSchemaPartitionsExec).

    ``full=True`` reads each matched partition's WHOLE series (cached chunk
    decode + buffer tail) and attaches store snapshot keys; the windowing
    path uses this so device tile caches hit across queries — the step grid
    itself restricts the evaluation to the query range.

    ``margin_ms`` widens the span a peer ships (a remote shard group sends
    only the span, SerializedRangeVector semantics) on each side. The
    windowing path passes its range window: the slide evaluator and the
    group-sum kernel read the sample next to each window's first and last,
    one sample interval past the span, and a cadence coarser than the
    window leaves at most one sample a window, where rate/increase/delta
    answer nothing. With it the peer's series are dense over every slot the
    grid reads, beside the local whole series, and the same tiles and
    kernels serve both (answers are unchanged: windows select by time)."""
    with obs_trace.span("select-series", shards=len(shards)) as _sp:
        memo = [0, 0]           # selection records built, reused
        try:
            out = _select_raw_series(shards, filters, start_ms, end_ms,
                                     column, stats, full, limits, deadline,
                                     margin_ms, memo)
            _sp.tag(series=len(out))
            return out
        finally:
            # counted also when a limit or the deadline cuts it short
            _sp.tag(memo_hits=memo[1], memo_misses=memo[0])
            reg = obs_metrics.GLOBAL_REGISTRY
            reg.counter(*SELECT_MEMO_HITS).inc(memo[1])
            reg.counter(*SELECT_MEMO_MISSES).inc(memo[0])


# (name, help) of the selection memo's counters, counted per series
SELECT_MEMO_HITS = ("filodb_select_memo_hits_total",
                    "Series whose selection record was reused (no write "
                    "to the partition since it was built)")
SELECT_MEMO_MISSES = ("filodb_select_memo_misses_total",
                      "Series whose selection record was (re)built")


def _selected_series(part, ci, ts, vals, chunk_len, num_chunks, shard,
                     col) -> RawSeries:
    """A partition's whole-series RawSeries for one column: the record
    ``TimeSeriesPartition.select_record`` memoizes. Its arrays are the
    decode cache's, read-only; queries share it, so nothing downstream
    writes to it."""
    les = drops = None
    if col.col_type == ColumnType.HISTOGRAM:
        if part._hist_scheme is not None:
            les = part._hist_scheme.les()
            les.setflags(write=False)
        if col.is_counter_like:
            # taken after read_full's snapshot: rows appended in
            # between may carry drop indices beyond ts.size
            drops = part.hist_drop_rows(ci)
            drops = drops[drops < ts.size]
            drops.setflags(write=False)
    return RawSeries(
        labels=dict(part.part_key.labels), ts=ts, values=vals,
        is_counter=col.is_counter_like, bucket_les=les,
        snapshot_key=(shard.ref.dataset, shard.shard_num, part.part_id,
                      num_chunks, ci),
        chunk_len=chunk_len, hist_drop_rows=drops)


_I64_MIN, _I64_MAX = -(1 << 63), (1 << 63) - 1


def _select_raw_series(shards, filters, start_ms, end_ms, column, stats,
                       full, limits, deadline, margin,
                       memo: List[int]) -> List[RawSeries]:
    """The series; counts the selection records built in ``memo[0]`` and
    those reused in ``memo[1]``."""
    out: List[RawSeries] = []
    # timestamps are whole ms: the samples in [start_ms, end_ms] are those
    # past the last <= ceil(start_ms) - 1 up to the last <= floor(end_ms),
    # one searchsorted call a series; bounds whose keys leave int64 (or
    # are NaN) take two calls with the bounds as given
    bounds = None
    if _I64_MIN < start_ms <= _I64_MAX and _I64_MIN <= end_ms <= _I64_MAX:
        bounds = np.array([math.ceil(start_ms) - 1, math.floor(end_ms)],
                          dtype=np.int64)
    cols: Dict[str, Tuple[int, object]] = {}     # schema name -> column
    for shard in shards:
        if deadline is not None:
            deadline.check("raw series selection")
        fetch_raw = getattr(shard, "fetch_raw", None)
        if fetch_raw is not None:       # RemoteShardGroup: peer dispatch
            try:
                got = fetch_raw(filters, start_ms - margin, end_ms + margin,
                                column, full=full)
            except StaleRoutingError:
                # NOT a degraded-mode drop: the peer refused because
                # our routing lags a handoff — the entry node must
                # re-resolve and retry, never serve the partial world
                raise
            except QueryError as e:
                # degraded mode: with allow_partial the lost shard group
                # drops out of the result and the response carries a
                # warning naming it; fail-fast (default) re-raises
                if not getattr(shard, "allow_partial", False) \
                        or stats is None:
                    raise
                desc = getattr(shard, "describe", None)
                who = desc() if desc is not None else \
                    f"node {getattr(shard, 'node_id', '?')}"
                stats.partial = True
                stats.warnings.append(
                    f"partial result: {who} unavailable ({e})")
                continue
            for s in got:
                if stats is not None:
                    stats.series_scanned += 1
                    # count the in-range samples, like the local branch —
                    # a full fetch ships the whole retention for caching
                    lo = int(np.searchsorted(s.ts, start_ms, side="left"))
                    hi = int(np.searchsorted(s.ts, end_ms, side="right"))
                    stats.samples_scanned += hi - lo
                    if limits is not None:
                        limits.check(stats)
            out.extend(got)
            continue
        for part in shard.lookup_partitions(filters, start_ms, end_ms):
            schema = part.schema
            got = cols.get(schema.name)
            if got is None:
                col_name = column or schema.value_column
                try:
                    ci = [c.name for c in schema.columns].index(col_name)
                except ValueError:
                    raise QueryError(
                        f"schema {schema.name} has no column {col_name}")
                got = cols[schema.name] = (ci, schema.columns[ci])
            s, hit = part.select_record(got[0], _selected_series, shard,
                                        got[1])
            memo[hit] += 1
            if bounds is not None:
                lo, hi = s.ts.searchsorted(bounds, "right").tolist()
            else:
                lo = int(np.searchsorted(s.ts, start_ms, side="left"))
                hi = int(np.searchsorted(s.ts, end_ms, side="right"))
            if not full:
                s = RawSeries(s.labels, s.ts[lo:hi], s.values[lo:hi],
                              s.is_counter, s.bucket_les)
            out.append(s)
            if stats is not None:
                stats.series_scanned += 1
                stats.samples_scanned += hi - lo
                if limits is not None:
                    limits.check(stats)     # abort before materializing more
    return out


def select_span_series(shards: Sequence[TimeSeriesShard],
                       filters: Sequence[ColumnFilter],
                       start_ms: int, end_ms: int,
                       column: Optional[str] = None,
                       stats: Optional[QueryStats] = None,
                       limits: Optional[QueryLimits] = None,
                       node_id: str = "", ds: str = "",
                       deadline=None) -> List[RawSeries]:
    """Leaf-dispatch selection: SPAN-BOUNDED reads with node-scoped
    snapshot keys — the SerializedRangeVector analogue
    (core/query/RangeVector.scala:452). The wire payload scales with the
    query span (lookback is already folded into ``start_ms`` by the
    planner), never with retention. Each series carries
    ``snapshot_key = (node, ds, shard, part, num_chunks, col, span)`` and
    ``chunk_len`` = its immutable in-span prefix, so the entry node's
    device tile cache reuses tiles across identical re-fetches while
    write-buffer tail rows are spliced live."""
    with obs_trace.span("select-span", shards=len(shards)) as _sp:
        out = _select_span_series(shards, filters, start_ms, end_ms,
                                  column, stats, limits, node_id, ds,
                                  deadline)
        _sp.tag(series=len(out))
        return out


def _select_span_series(shards, filters, start_ms, end_ms, column,
                        stats, limits, node_id, ds,
                        deadline) -> List[RawSeries]:
    out: List[RawSeries] = []
    for shard in shards:
        if deadline is not None:
            deadline.check("span series selection")
        for part in shard.lookup_partitions(filters, start_ms, end_ms):
            schema = part.schema
            col_name = column or schema.value_column
            try:
                ci = [c.name for c in schema.columns].index(col_name)
            except ValueError:
                raise QueryError(
                    f"schema {schema.name} has no column {col_name}")
            col = schema.columns[ci]
            ts_all, val_all, full_chunk_len = part.read_full(ci)
            lo = int(np.searchsorted(ts_all, start_ms, side="left"))
            hi = int(np.searchsorted(ts_all, end_ms, side="right"))
            ts, vals = ts_all[lo:hi], val_all[lo:hi]
            chunk_len = int(np.clip(full_chunk_len - lo, 0, hi - lo))
            snap = (node_id, ds, shard.shard_num, part.part_id,
                    part.num_chunks, ci, int(start_ms), int(end_ms))
            les = None
            drops = None
            if col.col_type == ColumnType.HISTOGRAM:
                les = part._hist_scheme.les() \
                    if part._hist_scheme is not None else None
                if col.is_counter_like:
                    d = part.hist_drop_rows(ci)
                    d = d[(d >= lo) & (d < hi)] - lo
                    drops = d
            out.append(RawSeries(
                labels=dict(part.part_key.labels),
                ts=ts, values=vals,
                is_counter=col.is_counter_like,
                bucket_les=les,
                snapshot_key=snap,
                chunk_len=chunk_len,
                hist_drop_rows=drops,
            ))
            if stats is not None:
                stats.series_scanned += 1
                stats.samples_scanned += int(ts.size)
                if limits is not None:
                    limits.check(stats)
    return out


def clip_series(series: Sequence[RawSeries], start_ms: int, end_ms: int
                ) -> List[RawSeries]:
    """Restrict each series to samples in [start_ms, end_ms] (views, no
    copies). Used to hand the oracle / general device path only the span a
    window grid can touch, while tile caches keep the full snapshot."""
    out = []
    for s in series:
        lo = int(np.searchsorted(s.ts, start_ms, side="left"))
        hi = int(np.searchsorted(s.ts, end_ms, side="right"))
        if lo == 0 and hi == s.ts.size:
            out.append(s)
        else:
            dr = s.hist_drop_rows
            if dr is not None:
                dr = dr[(dr >= lo) & (dr < hi)] - lo
            out.append(RawSeries(s.labels, s.ts[lo:hi], s.values[lo:hi],
                                 s.is_counter, s.bucket_les,
                                 hist_drop_rows=dr))
    return out


# ---------------------------------------------------------------------------
# Periodic sampling / windowing (PeriodicSamplesMapper)
# ---------------------------------------------------------------------------

def periodic_samples(series: Sequence[RawSeries], params: RangeParams,
                     function: Optional[str], window_ms: int,
                     func_args: Sequence[float] = (),
                     offset_ms: int = 0) -> GridResult:
    """Apply a range function (or lookback last-sample) per series onto the
    step grid (exec/PeriodicSamplesMapper.scala:61; ChunkedWindowIterator
    :223 hot loop, vectorized)."""
    steps = params.steps
    wend = steps - offset_ms
    wstart = wend - window_ms
    func = function or "last_sample"
    s1 = func_args[0] if len(func_args) > 0 else None
    s2 = func_args[1] if len(func_args) > 1 else None

    keys: List[Dict[str, str]] = []
    rows: List[np.ndarray] = []
    hist_rows: List[np.ndarray] = []
    les = None
    any_hist = False
    for s in series:
        if s.values.ndim == 2:
            any_hist = True
            break

    if not any_hist:
        fn = rf.RANGE_FUNCTIONS.get(func)
        if fn is None:
            raise QueryError(f"unknown range function {func}")
        for s in series:
            keys.append(dict(s.labels))
            rows.append(fn(s.ts, s.values, wstart, wend,
                           scalar=s1, scalar2=s2))
        values = np.vstack(rows) if rows else np.zeros((0, steps.size))
        return GridResult(steps, keys, values)

    # histogram path: apply per bucket (HistogramRateFunctionBase,
    # RateFunctions.scala:249; SumOverTimeChunkedFunctionH)
    for s in series:
        keys.append(dict(s.labels))
        if s.values.ndim != 2:
            raise QueryError("mixed histogram/double inputs")
        les = s.bucket_les if s.bucket_les is not None else les
        hist_rows.append(_hist_window(s, func, wstart, wend))
    if hist_rows:
        nb = max(h.shape[1] for h in hist_rows)
        hist_rows = [h if h.shape[1] == nb else
                     np.pad(h, ((0, 0), (0, nb - h.shape[1]), (0, 0)),
                            constant_values=np.nan)
                     for h in hist_rows]
    hv = np.stack(hist_rows) if hist_rows else np.zeros((0, 0, steps.size))
    hv = np.transpose(hv, (0, 2, 1))  # [S, T, NB]
    return GridResult(steps, keys, np.full((len(keys), steps.size), np.nan),
                      hist_values=hv, bucket_les=les)


def _hist_window(s: RawSeries, func: str, wstart, wend) -> np.ndarray:
    """Evaluate a range function over a histogram series, per bucket.
    Returns [NB, T]."""
    ts = s.ts
    mat = s.values  # [n, nb]
    nb = mat.shape[1] if mat.size else 0
    if func in ("rate", "increase"):
        corrected = mat + bh.hist_counter_correction(
            mat, drop_rows=s.hist_drop_rows) if s.is_counter else mat
        out = np.empty((nb, wstart.size))
        lo, hi = rf.window_bounds(ts, wstart, wend)
        counts = hi - lo + 1
        lo_c = np.clip(lo, 0, max(ts.size - 1, 0))
        hi_c = np.clip(hi, 0, max(ts.size - 1, 0))
        for b in range(nb):
            if ts.size == 0:
                out[b] = np.nan
                continue
            out[b] = rf.extrapolated_rate(
                wstart, wend, counts,
                ts[lo_c], corrected[lo_c, b], ts[hi_c], corrected[hi_c, b],
                True, func == "rate")
        return out
    if func in ("sum_over_time", "rate_over_delta", "increase_over_delta"):
        out = np.empty((nb, wstart.size))
        for b in range(nb):
            out[b] = rf.RANGE_FUNCTIONS[
                "sum_over_time" if func != "rate_over_delta" else
                "rate_over_delta"](ts, mat[:, b], wstart, wend)
        return out
    if func == "last_sample":
        out = np.empty((nb, wstart.size))
        for b in range(nb):
            out[b] = rf.RANGE_FUNCTIONS["last_sample"](
                ts, mat[:, b], wstart, wend)
        return out
    raise QueryError(f"range function {func} unsupported for histograms")


# ---------------------------------------------------------------------------
# Aggregations across series (RowAggregator / AggregateMapReduce)
# ---------------------------------------------------------------------------

def _group_keys(keys: List[Dict[str, str]], by: Tuple[str, ...],
                without: Tuple[str, ...]):
    """Group index per series (AggregateMapReduce grouping,
    AggrOverRangeVectors.scala:98)."""
    gids: List[int] = []
    gkeys: List[Dict[str, str]] = []
    seen: Dict[Tuple, int] = {}
    for k in keys:
        k2 = strip_metric(k)
        if by:
            gk = {l: k2[l] for l in by if l in k2}
        elif without:
            gk = {l: v for l, v in k2.items() if l not in without}
        else:
            gk = {}
        key = tuple(sorted(gk.items()))
        gid = seen.setdefault(key, len(seen))
        if gid == len(gkeys):
            gkeys.append(gk)
        gids.append(gid)
    return np.array(gids, dtype=np.int64), gkeys


def aggregate(grid: GridResult, op: str, params: Tuple = (),
              by: Tuple[str, ...] = (), without: Tuple[str, ...] = ()
              ) -> GridResult:
    """Cross-series aggregation on the grid
    (exec/aggregator/*.scala map-reduce-present protocol), on the host:
    the ``aggregate`` span, tagged ``op`` and ``groups``."""
    with obs_trace.span("aggregate", op=op) as sp:
        out = _aggregate(grid, op, params, by, without)
        sp.tag(groups=out.num_series)
    return out


def _aggregate(grid: GridResult, op: str, params: Tuple,
               by: Tuple[str, ...], without: Tuple[str, ...]
               ) -> GridResult:
    if grid.is_hist() and op == "sum":
        return _aggregate_hist_sum(grid, by, without)
    v = grid.values  # [S, T]
    steps = grid.steps
    if grid.num_series == 0:
        return GridResult(steps, [], np.zeros((0, steps.size)))
    gids, gkeys = _group_keys(grid.keys, tuple(by), tuple(without))
    ng = len(gkeys)
    T = steps.size
    present = ~np.isnan(v)
    vz = np.where(present, v, 0.0)

    def seg(arr):  # segment sum over groups
        out = np.zeros((ng, T))
        np.add.at(out, gids, arr)
        return out

    cnt = seg(present.astype(np.float64))
    none = cnt == 0
    with np.errstate(invalid="ignore", divide="ignore"):
        if op == "sum":
            out = seg(vz)
        elif op == "count":
            out = cnt
        elif op == "avg":
            out = seg(vz) / cnt
        elif op == "group":
            out = np.ones((ng, T))
        elif op in ("min", "max"):
            fill = np.inf if op == "min" else -np.inf
            vf = np.where(present, v, fill)
            out = np.full((ng, T), fill)
            ufunc = np.minimum if op == "min" else np.maximum
            ufunc.at(out, gids, vf)
            out = np.where(np.isinf(out), np.nan, out)
        elif op in ("stddev", "stdvar"):
            s = seg(vz)
            s2 = seg(vz * vz)
            mean = s / cnt
            var = np.maximum(s2 / cnt - mean * mean, 0.0)
            out = var if op == "stdvar" else np.sqrt(var)
        elif op in ("topk", "bottomk"):
            try:
                k = int(params[0])
            except (TypeError, ValueError, IndexError):
                raise QueryError(f"{op} expects a numeric k parameter")
            return _topk(grid, k, gids, gkeys,
                         bottom=(op == "bottomk"))
        elif op == "quantile":
            try:
                q = float(params[0])
            except (TypeError, ValueError, IndexError):
                raise QueryError("quantile expects a numeric parameter")
            out = np.full((ng, T), np.nan)
            for g in range(ng):
                sel = v[gids == g]  # [Sg, T]
                with np.errstate(all="ignore"):
                    out[g] = np.nanquantile(sel, min(max(q, 0), 1), axis=0) \
                        if 0 <= q <= 1 else (np.inf if q > 1 else -np.inf)
        elif op == "count_values":
            return _count_values(grid, str(params[0]), gids, gkeys)
        elif op == "absent":
            out = np.where(cnt == 0, 1.0, np.nan)
            none = np.zeros_like(none)
        else:
            raise QueryError(f"unknown aggregation op {op}")
    out = np.where(none, np.nan, out)
    return GridResult(steps, gkeys, out)


def _aggregate_hist_sum(grid: GridResult, by, without) -> GridResult:
    gids, gkeys = _group_keys(grid.keys, tuple(by), tuple(without))
    ng = len(gkeys)
    hv = grid.hist_values  # [S, T, NB]
    present = ~np.isnan(hv)
    out = np.zeros((ng,) + hv.shape[1:])
    np.add.at(out, gids, np.where(present, hv, 0.0))
    cnt = np.zeros((ng,) + hv.shape[1:])
    np.add.at(cnt, gids, present.astype(np.float64))
    out = np.where(cnt == 0, np.nan, out)
    return GridResult(grid.steps, gkeys,
                      np.full((ng, grid.steps.size), np.nan),
                      hist_values=out, bucket_les=grid.bucket_les)


def _topk(grid: GridResult, k: int, gids, gkeys, bottom: bool) -> GridResult:
    """topk/bottomk: per step, keep k best series per group; output is the
    union of selected series with NaN elsewhere (TopBottomK aggregator)."""
    v = grid.values
    S, T = v.shape
    out_rows: List[np.ndarray] = []
    out_keys: List[Dict[str, str]] = []
    for g in range(len(gkeys)):
        idx = np.where(gids == g)[0]
        sub = v[idx]  # [Sg, T]
        score = np.where(np.isnan(sub), -np.inf if not bottom else np.inf, sub)
        order = np.argsort(-score if not bottom else score, axis=0,
                           kind="stable")
        keep = np.zeros_like(sub, dtype=bool)
        kk = min(k, sub.shape[0])
        cols = np.arange(T)
        for r in range(kk):
            keep[order[r], cols] = True
        keep &= ~np.isnan(sub)
        for i, si in enumerate(idx):
            if keep[i].any():
                out_keys.append(dict(grid.keys[si]))
                out_rows.append(np.where(keep[i], sub[i], np.nan))
    values = np.vstack(out_rows) if out_rows else np.zeros((0, T))
    return GridResult(grid.steps, out_keys, values)


def _count_values(grid: GridResult, label: str, gids, gkeys) -> GridResult:
    v = grid.values
    T = grid.steps.size
    buckets: Dict[Tuple[int, str], np.ndarray] = {}
    for s in range(v.shape[0]):
        g = gids[s]
        for t in range(T):
            x = v[s, t]
            if np.isnan(x):
                continue
            key = (g, repr(float(x)) if x != int(x) else str(int(x)))
            row = buckets.setdefault(key, np.zeros(T))
            row[t] += 1
    keys_out: List[Dict[str, str]] = []
    rows = []
    for (g, val), row in sorted(buckets.items(), key=lambda kv: kv[0][1]):
        k = dict(gkeys[g])
        k[label] = val
        keys_out.append(k)
        rows.append(np.where(row == 0, np.nan, row))
    values = np.vstack(rows) if rows else np.zeros((0, T))
    return GridResult(grid.steps, keys_out, values)


# ---------------------------------------------------------------------------
# Binary operations (BinaryJoinExec, SetOperatorExec, ScalarOperationMapper)
# ---------------------------------------------------------------------------

_ARITH = {
    "+": np.add, "-": np.subtract, "*": np.multiply,
    "/": np.divide, "^": np.power,
}
_COMP = {
    "==": np.equal, "!=": np.not_equal, ">": np.greater,
    "<": np.less, ">=": np.greater_equal, "<=": np.less_equal,
}


def _apply_op(op: str, a, b, return_bool: bool):
    with np.errstate(all="ignore"):
        if op in _ARITH:
            return _ARITH[op](a, b)
        if op == "%":
            return np.fmod(a, b)
        if op == "atan2":
            return np.arctan2(a, b)
        if op in _COMP:
            m = _COMP[op](a, b)
            if return_bool:
                out = m.astype(np.float64)
                nan = np.isnan(a) | np.isnan(b)
                return np.where(nan, np.nan, out)
            return np.where(m, a, np.nan)
    raise QueryError(f"unknown binary op {op}")


def scalar_vector_op(grid: GridResult, scalar, op: str, scalar_is_lhs: bool,
                     return_bool: bool = False) -> GridResult:
    """(exec/RangeVectorTransformer.scala:201 ScalarOperationMapper).

    A FILTERING comparison (no ``bool``) always retains the VECTOR
    side's sample values regardless of operand order — ``10 < foo``
    keeps foo's values, not a broadcast 10. The generic ``_apply_op``
    filter keeps its left operand, which is only correct when the
    vector IS the left operand; pinned by the promql differential
    rail (test_pinned_scalar_lhs_comparison_filter)."""
    sv = scalar.values if isinstance(scalar, ScalarResult) else scalar
    a, b = (sv, grid.values) if scalar_is_lhs else (grid.values, sv)
    if op in _COMP and not return_bool:
        with np.errstate(all="ignore"):
            m = _COMP[op](a, b)
        out = np.where(m, grid.values, np.nan)
    else:
        out = _apply_op(op, a, b, return_bool)
    keys = [strip_metric(k) for k in grid.keys]
    return GridResult(grid.steps, keys, out)


def _join_key(labels: Mapping[str, str], on: Optional[Tuple[str, ...]],
              ignoring: Tuple[str, ...]) -> Tuple:
    l2 = strip_metric(labels)
    if on is not None:
        return tuple(sorted((k, v) for k, v in l2.items() if k in on))
    return tuple(sorted((k, v) for k, v in l2.items() if k not in ignoring))


def binary_join(lhs: GridResult, rhs: GridResult, op: str,
                cardinality: str = "one-to-one",
                on: Optional[Tuple[str, ...]] = None,
                ignoring: Tuple[str, ...] = (),
                include: Tuple[str, ...] = (),
                return_bool: bool = False) -> GridResult:
    """Vector-vector binary operation with label matching
    (exec/BinaryJoinExec.scala:58; set ops SetOperatorExec.scala:32)."""
    steps = lhs.steps
    if op in ("and", "or", "unless"):
        return _set_op(lhs, rhs, op, on, ignoring)

    # grouped joins: evaluate in-place with the ORIGINAL operand order —
    # swapping sides is wrong for non-commutative ops (-,/,^,%,atan2) —
    # output labels come from the "many" side (group_left: lhs is many,
    # group_right: rhs is many), include labels copied from the "one" side.
    if cardinality in ("many-to-one", "one-to-many"):
        many, one = ((lhs, rhs) if cardinality == "many-to-one"
                     else (rhs, lhs))
        omap: Dict[Tuple, int] = {}
        for j, k in enumerate(one.keys):
            key = _join_key(k, on, ignoring)
            if key in omap:
                raise QueryError(
                    "many-to-many join: duplicate series on 'one' side")
            omap[key] = j
        out_keys = []
        rows = []
        for i, k in enumerate(many.keys):
            key = _join_key(k, on, ignoring)
            j = omap.get(key)
            if j is None:
                continue
            if cardinality == "many-to-one":
                a, b = lhs.values[i], rhs.values[j]
            else:
                a, b = lhs.values[j], rhs.values[i]
            out = _apply_op(op, a, b, return_bool)
            labels = dict(strip_metric(k))
            for l in include:
                if l in one.keys[j]:
                    labels[l] = one.keys[j][l]
                else:
                    labels.pop(l, None)
            rows.append(out)
            out_keys.append(labels)
        values = np.vstack(rows) if rows else np.zeros((0, steps.size))
        return GridResult(steps, out_keys, values)

    rmap: Dict[Tuple, List[int]] = {}
    for j, k in enumerate(rhs.keys):
        rmap.setdefault(_join_key(k, on, ignoring), []).append(j)
    for key, js in rmap.items():
        if len(js) > 1:
            raise QueryError(
                "many-to-many join: duplicate series on right side")
    out_keys: List[Dict[str, str]] = []
    rows: List[np.ndarray] = []
    seen_left: Dict[Tuple, int] = {}
    for i, k in enumerate(lhs.keys):
        key = _join_key(k, on, ignoring)
        js = rmap.get(key)
        if not js:
            continue
        if key in seen_left:
            raise QueryError(
                "many-to-many join: duplicate series on left side")
        seen_left[key] = i
        j = js[0]
        a, b = lhs.values[i], rhs.values[j]
        out = _apply_op(op, a, b, return_bool)
        rows.append(out)
        out_keys.append(dict(strip_metric(k)))
    values = np.vstack(rows) if rows else np.zeros((0, steps.size))
    return GridResult(steps, out_keys, values)


def _set_op(lhs: GridResult, rhs: GridResult, op: str,
            on: Optional[Tuple[str, ...]], ignoring: Tuple[str, ...]
            ) -> GridResult:
    rkeys = {_join_key(k, on, ignoring): j for j, k in enumerate(rhs.keys)}
    steps = lhs.steps
    keys_out: List[Dict[str, str]] = []
    rows: List[np.ndarray] = []
    if op == "and":
        for i, k in enumerate(lhs.keys):
            j = rkeys.get(_join_key(k, on, ignoring))
            if j is None:
                continue
            mask = ~np.isnan(rhs.values[j])
            keys_out.append(dict(k))
            rows.append(np.where(mask, lhs.values[i], np.nan))
    elif op == "unless":
        for i, k in enumerate(lhs.keys):
            j = rkeys.get(_join_key(k, on, ignoring))
            row = lhs.values[i]
            if j is not None:
                row = np.where(np.isnan(rhs.values[j]), row, np.nan)
            keys_out.append(dict(k))
            rows.append(row)
    elif op == "or":
        lkeys = set()
        for i, k in enumerate(lhs.keys):
            lkeys.add(_join_key(k, on, ignoring))
            keys_out.append(dict(k))
            rows.append(lhs.values[i])
        for j, k in enumerate(rhs.keys):
            if _join_key(k, on, ignoring) not in lkeys:
                keys_out.append(dict(k))
                rows.append(rhs.values[j])
    values = np.vstack(rows) if rows else np.zeros((0, steps.size))
    return GridResult(steps, keys_out, values)


# ---------------------------------------------------------------------------
# Instant functions (rangefn/InstantFunction.scala)
# ---------------------------------------------------------------------------

_INSTANT_UNARY = {
    "abs": np.abs, "ceil": np.ceil, "floor": np.floor, "exp": np.exp,
    "ln": np.log, "log2": np.log2, "log10": np.log10, "sqrt": np.sqrt,
    "round": None, "sgn": np.sign,
    "acos": np.arccos, "asin": np.arcsin, "atan": np.arctan, "cos": np.cos,
    "cosh": np.cosh, "sin": np.sin, "sinh": np.sinh, "tan": np.tan,
    "tanh": np.tanh, "deg": np.degrees, "rad": np.radians,
}


def instant_function(grid: GridResult, func: str,
                     args: Sequence[float] = ()) -> GridResult:
    """(exec/RangeVectorTransformer.scala:62 InstantVectorFunctionMapper)."""
    keys = [strip_metric(k) for k in grid.keys]
    with np.errstate(all="ignore"):
        if func == "histogram_quantile":
            return histogram_quantile(grid, float(args[0]))
        if func == "histogram_bucket":
            return histogram_bucket(grid, float(args[0]))
        if func == "histogram_max_quantile":
            return histogram_quantile(grid, float(args[0]))
        if func in _INSTANT_UNARY:
            if func == "round":
                to_nearest = float(args[0]) if args else 1.0
                out = np.floor(grid.values / to_nearest + 0.5) * to_nearest
            else:
                out = _INSTANT_UNARY[func](grid.values)
            return GridResult(grid.steps, keys, out)
        if func == "clamp":
            out = np.clip(grid.values, float(args[0]), float(args[1]))
            return GridResult(grid.steps, keys, out)
        if func == "clamp_min":
            return GridResult(grid.steps, keys,
                              np.maximum(grid.values, float(args[0])))
        if func == "clamp_max":
            return GridResult(grid.steps, keys,
                              np.minimum(grid.values, float(args[0])))
        if func in ("days_in_month", "day_of_month", "day_of_week",
                    "day_of_year", "hour", "minute", "month", "year"):
            return _time_component(grid, func, keys)
    raise QueryError(f"unknown instant function {func}")


def _time_component(grid: GridResult, func: str, keys) -> GridResult:
    import datetime as dt
    v = grid.values
    out = np.full_like(v, np.nan)
    it = np.nditer(v, flags=["multi_index"])
    for x in it:
        if np.isnan(x):
            continue
        d = dt.datetime.fromtimestamp(float(x), dt.timezone.utc)
        out[it.multi_index] = {
            "days_in_month": ((d.replace(month=d.month % 12 + 1, day=1,
                                         year=d.year + d.month // 12)
                               - dt.timedelta(days=1)).day),
            "day_of_month": d.day,
            "day_of_week": (d.weekday() + 1) % 7,
            "day_of_year": d.timetuple().tm_yday,
            "hour": d.hour,
            "minute": d.minute,
            "month": d.month,
            "year": d.year,
        }[func]
    return GridResult(grid.steps, keys, out)


def histogram_quantile(grid: GridResult, q: float) -> GridResult:
    """histogram_quantile over native histogram columns — vectorized over
    [S, T] (InstantFunction.scala HistogramQuantileImpl; bucket math
    memory/format/vectors/Histogram.scala quantile). Non-histogram input
    falls back to the classic per-bucket `le`-series join
    (exec/HistogramQuantileMapper.scala)."""
    if not grid.is_hist():
        return _quantile_over_le_series(grid, q)
    hv = grid.hist_values  # [S, T, NB]
    les = np.asarray(grid.bucket_les, dtype=np.float64)
    S, T, NB = hv.shape
    out = np.full((S, T), np.nan)
    for s in range(S):
        for t in range(T):
            col = hv[s, t]
            if np.isnan(col[-1]):
                continue
            out[s, t] = bh.quantile(q, les, col)
    keys = [strip_metric(k) for k in grid.keys]
    return GridResult(grid.steps, keys, out)


def _quantile_over_le_series(grid: GridResult, q: float) -> GridResult:
    """histogram_quantile over classic per-bucket prom series: join series
    sharing all labels except `le` into one cumulative histogram per step
    (exec/HistogramQuantileMapper.scala — sorts bucket RVs by le, enforces
    monotonicity like Prometheus' ensureMonotonic, then bucket math)."""
    groups: Dict[Tuple, List[Tuple[float, int]]] = {}
    for i, k in enumerate(grid.keys):
        le_s = k.get("le")
        if le_s is None:
            continue        # non-bucket series are ignored (reference too)
        try:
            le = float(le_s.replace("+Inf", "inf")) \
                if isinstance(le_s, str) else float(le_s)
        except ValueError:
            continue
        base = tuple(sorted((kk, v) for kk, v in strip_metric(k).items()
                            if kk != "le"))
        groups.setdefault(base, []).append((le, i))
    if not groups:
        raise QueryError("histogram_quantile requires histogram input or "
                         "per-bucket series with an 'le' label")
    T = grid.steps.size
    out_keys: List[Dict[str, str]] = []
    rows: List[np.ndarray] = []
    for base, members in groups.items():
        members.sort(key=lambda m: m[0])
        les = np.array([m[0] for m in members])
        mat = grid.values[[m[1] for m in members]]   # [NB, T] cumulative
        vals = np.full(T, np.nan)
        for t in range(T):
            col = mat[:, t]
            present = ~np.isnan(col)     # a stale bucket series at this
            if not present.any():        # step doesn't poison the rest
                continue
            lc = les[present]
            if not np.isposinf(lc[-1]):
                continue    # no +Inf bucket sample: NaN (Prometheus)
            # Prometheus tolerates tiny non-monotonicity from float
            # noise / scrape skew: running max down the buckets
            vals[t] = bh.quantile(q, lc,
                                  np.maximum.accumulate(col[present]))
        out_keys.append(dict(base))
        rows.append(vals)
    values = np.vstack(rows) if rows else np.zeros((0, T))
    return GridResult(grid.steps, out_keys, values)


def histogram_bucket(grid: GridResult, le: float) -> GridResult:
    if not grid.is_hist():
        raise QueryError("histogram_bucket requires histogram input")
    les = np.asarray(grid.bucket_les, dtype=np.float64)
    idx = np.where(les == le)[0]
    keys = [strip_metric(k) for k in grid.keys]
    if idx.size == 0:
        return GridResult(grid.steps, keys,
                          np.full(grid.hist_values.shape[:2], np.nan))
    return GridResult(grid.steps, keys, grid.hist_values[:, :, idx[0]])


# ---------------------------------------------------------------------------
# Miscellaneous functions (MiscellaneousFunction.scala)
# ---------------------------------------------------------------------------

def label_replace(grid: GridResult, dst: str, repl: str, src: str,
                  regex: str) -> GridResult:
    try:
        pat = re.compile(regex)
    except re.error as e:
        raise QueryError(f"invalid regex: {e}")
    keys = []
    for k in grid.keys:
        k = dict(k)
        val = k.get(src, "")
        m = pat.fullmatch(val)
        if m:
            new = m.expand(_promql_template(repl))
            if new:
                k[dst] = new
            else:
                k.pop(dst, None)
        keys.append(k)
    return GridResult(grid.steps, keys, grid.values, grid.hist_values,
                      grid.bucket_les)


def _promql_template(repl: str) -> str:
    # PromQL uses $1; python re.expand uses \1
    return re.sub(r"\$(\d+)", r"\\\1", repl)


def label_join(grid: GridResult, dst: str, sep: str,
               srcs: Sequence[str]) -> GridResult:
    keys = []
    for k in grid.keys:
        k = dict(k)
        k[dst] = sep.join(k.get(s, "") for s in srcs)
        keys.append(k)
    return GridResult(grid.steps, keys, grid.values, grid.hist_values,
                      grid.bucket_les)


def sort_grid(grid: GridResult, descending: bool) -> GridResult:
    """sort()/sort_desc(): order series by value of last step
    (SortFunctionMapper :297)."""
    if grid.num_series == 0:
        return grid
    lastv = grid.values[:, -1]
    score = np.where(np.isnan(lastv), -np.inf if not descending else np.inf,
                     lastv)
    order = np.argsort(-score if descending else score, kind="stable")
    return GridResult(grid.steps, [grid.keys[i] for i in order],
                      grid.values[order])


def limit_grid(grid: GridResult, limit: int) -> GridResult:
    if limit <= 0 or grid.num_series <= limit:
        return grid
    return GridResult(grid.steps, grid.keys[:limit], grid.values[:limit],
                      None if grid.hist_values is None
                      else grid.hist_values[:limit], grid.bucket_les)


def absent_fn(grid: GridResult, filters: Sequence[ColumnFilter],
              steps: np.ndarray) -> GridResult:
    """absent(): 1 where no series has a value (AbsentFunctionMapper :420).
    Output labels come from equality filters (Prometheus semantics)."""
    if grid.num_series == 0:
        present = np.zeros(steps.size, dtype=bool)
    else:
        present = (~np.isnan(grid.values)).any(axis=0)
    out = np.where(present, np.nan, 1.0)
    labels = {f.label: f.value for f in filters
              if f.op == "eq" and f.label not in METRIC_LABELS}
    if present.all():
        return GridResult(steps, [], np.zeros((0, steps.size)))
    return GridResult(steps, [labels], out[None, :])


# ---------------------------------------------------------------------------
# Scalar plans
# ---------------------------------------------------------------------------

def eval_scalar(plan, engine) -> ScalarResult:
    if isinstance(plan, lp.ScalarFixedDoublePlan):
        steps = RangeParams(plan.start_ms, plan.step_ms, plan.end_ms).steps
        return ScalarResult(steps, np.full(steps.size, plan.value))
    if isinstance(plan, lp.ScalarTimeBasedPlan):
        steps = RangeParams(plan.start_ms, plan.step_ms, plan.end_ms).steps
        if plan.function == "time":
            return ScalarResult(steps, steps / 1000.0)
        raise QueryError(f"unknown scalar time function {plan.function}")
    if isinstance(plan, lp.ScalarVaryingDoublePlan):
        grid = engine.execute(plan.inner)
        # scalar(v): value when exactly one series, else NaN — per step
        if grid.num_series == 1:
            vals = grid.values[0]
        elif grid.num_series == 0:
            vals = np.full(grid.steps.size, np.nan)
        else:
            cnt = (~np.isnan(grid.values)).sum(axis=0)
            vals = np.where(cnt == 1, np.nansum(grid.values, axis=0), np.nan)
        return ScalarResult(grid.steps, vals)
    if isinstance(plan, lp.ScalarBinaryOperation):
        def side(x):
            if isinstance(x, (int, float)):
                return float(x)
            return eval_scalar(x, engine).values
        a, b = side(plan.lhs), side(plan.rhs)
        out = _apply_op(plan.op, a, b, return_bool=True) \
            if plan.op in _COMP else _apply_op(plan.op, a, b, False)
        steps = RangeParams(plan.start_ms, plan.step_ms, plan.end_ms).steps
        if np.isscalar(out) or out.ndim == 0:
            out = np.full(steps.size, float(out))
        return ScalarResult(steps, out)
    raise QueryError(f"not a scalar plan: {plan}")


# ---------------------------------------------------------------------------
# The engine: logical plan walker
# ---------------------------------------------------------------------------

class QueryEngine:
    """Evaluates LogicalPlans against shards (single-process oracle).

    The distributed path (filodb_tpu_torch.parallel) re-uses these primitives with
    per-shard leaf evaluation + mesh reductions."""

    def __init__(self, shards: Sequence[TimeSeriesShard],
                 backend: Optional[object] = None,
                 limits: Optional[QueryLimits] = None):
        self.shards = list(shards)
        self.stats = QueryStats()
        self.backend = backend  # TPU backend hook (query/tpu.py)
        self.limits = limits    # per-query guardrails (None = off)

    # -- public ----------------------------------------------------------
    def execute(self, plan):
        if lp.is_scalar_plan(plan):
            return eval_scalar(plan, self)
        # metadata plans read local tag indexes only; cross-node metadata
        # is unioned at the HTTP layer (peer fan-out)
        local = [s for s in self.shards if not hasattr(s, "fetch_raw")]
        if isinstance(plan, lp.LabelValues):
            vals: set = set()
            for s in local:
                vals.update(s.index.label_values(
                    plan.label, plan.filters, plan.start_ms, plan.end_ms))
            return sorted(vals)
        if isinstance(plan, lp.LabelNames):
            names: set = set()
            for s in local:
                names.update(s.index.label_names(
                    plan.filters, plan.start_ms, plan.end_ms))
            return sorted(names)
        if isinstance(plan, lp.SeriesKeysByFilters):
            out = []
            for s in local:
                for pid in s.index.part_ids_from_filters(
                        plan.filters, plan.start_ms, plan.end_ms):
                    out.append(dict(s.index.labels_for(pid)))
            return out
        if isinstance(plan, lp.TsCardinalities):
            from filodb_tpu_torch.core.cardinality import merge_records
            per = []
            for s in local:
                tracker = getattr(s, "card_tracker", None)
                if tracker is not None:
                    per.append(tracker.scan(plan.shard_key_prefix,
                                            plan.num_groups))
            return merge_records(per)
        return self._eval(plan)

    # -- vector evaluation ------------------------------------------------
    def _eval(self, plan) -> GridResult:
        if isinstance(plan, lp.PeriodicSeries):
            if plan.at_ms is not None:
                return self._at_pinned(plan.raw, plan.at_ms, None,
                                       plan.lookback_ms, (), plan.offset_ms,
                                       plan.start_ms, plan.step_ms,
                                       plan.end_ms)
            return self._periodic(plan.raw, plan.start_ms, plan.step_ms,
                                  plan.end_ms, None, plan.lookback_ms, (),
                                  plan.offset_ms)
        if isinstance(plan, lp.PeriodicSeriesWithWindowing):
            if plan.at_ms is not None:
                return self._at_pinned(plan.raw, plan.at_ms, plan.function,
                                       plan.window_ms, plan.func_args,
                                       plan.offset_ms, plan.start_ms,
                                       plan.step_ms, plan.end_ms)
            return self._periodic(plan.raw, plan.start_ms, plan.step_ms,
                                  plan.end_ms, plan.function, plan.window_ms,
                                  plan.func_args, plan.offset_ms)
        if isinstance(plan, lp.SubqueryWithWindowing):
            return self._subquery(plan)
        if isinstance(plan, lp.TopLevelSubquery):
            return self._eval(plan.inner)
        if isinstance(plan, lp.Aggregate):
            fused = self._try_fused_agg(plan)
            if fused is not None:
                return fused
            inner = self._eval(plan.inner)
            return aggregate(inner, plan.op, plan.params, tuple(plan.by),
                             tuple(plan.without))
        if isinstance(plan, lp.BinaryJoin):
            lhs = self._eval(plan.lhs)
            rhs = self._eval(plan.rhs)
            return binary_join(lhs, rhs, plan.op, plan.cardinality, plan.on,
                               plan.ignoring, plan.include, plan.return_bool)
        if isinstance(plan, lp.ScalarVectorBinaryOperation):
            grid = self._eval(plan.vector)
            scalar = eval_scalar(plan.scalar, self)
            return scalar_vector_op(grid, scalar, plan.op, plan.scalar_is_lhs,
                                    plan.return_bool)
        if isinstance(plan, lp.ApplyInstantFunction):
            grid = self._eval(plan.inner)
            args = [eval_scalar(a, self).values[0] if not isinstance(
                a, (int, float)) else a for a in plan.func_args]
            return instant_function(grid, plan.function, args)
        if isinstance(plan, lp.ApplyMiscellaneousFunction):
            grid = self._eval(plan.inner)
            if plan.function == "label_replace":
                return label_replace(grid, *plan.str_args)
            if plan.function == "label_join":
                dst, sep, *srcs = plan.str_args
                return label_join(grid, dst, sep, srcs)
            raise QueryError(f"unknown misc function {plan.function}")
        if isinstance(plan, lp.ApplySortFunction):
            return sort_grid(self._eval(plan.inner), plan.descending)
        if isinstance(plan, lp.ApplyLimitFunction):
            return limit_grid(self._eval(plan.inner), plan.limit)
        if isinstance(plan, lp.ApplyAbsentFunction):
            grid = self._eval(plan.inner)
            steps = RangeParams(plan.start_ms, plan.step_ms, plan.end_ms).steps
            return absent_fn(grid, plan.filters, steps)
        if isinstance(plan, lp.VectorPlan):
            sc = eval_scalar(plan.scalar, self)
            return GridResult(sc.steps, [{}], sc.values[None, :])
        if isinstance(plan, lp.RawSeriesPlan):
            # raw export (query endpoint with [range] at top level)
            series = select_raw_series(self.shards, plan.filters,
                                       plan.start_ms, plan.end_ms,
                                       plan.column, self.stats,
                                       limits=self.limits)
            return series
        raise QueryError(f"cannot execute plan {type(plan).__name__}")

    def _try_fused_agg(self, plan) -> Optional[GridResult]:
        """`sum/avg/count by (g) (rate/increase/delta(sel[w]))` fused
        end-to-end on device: grouping happens inside the Pallas
        group-sum kernel and the [S, T] per-series intermediate never
        exists (exec/AggrOverRangeVectors map-reduce, fused).

        None is returned only for plan SHAPES this path doesn't own;
        once the series are selected, any kernel ineligibility
        (irregular cadence, tail data, histograms, non-divisible grid)
        falls back to rangefn + aggregate() over the SAME selection —
        never a second fetch (remote shard groups pull raw series over
        the wire) or double-counted stats."""
        if self.backend is None or plan.op not in ("sum", "count", "avg"):
            return None
        if plan.params:
            return None
        inner = plan.inner
        if not isinstance(inner, lp.PeriodicSeriesWithWindowing):
            return None
        if inner.at_ms is not None or inner.func_args or \
                inner.function not in _COUNTER_FUNCS:
            return None
        raw = inner.raw
        if not isinstance(raw, lp.RawSeriesPlan):
            return None
        fetch_start = inner.start_ms - inner.window_ms - inner.offset_ms
        fetch_end = (inner.end_ms - inner.offset_ms if inner.offset_ms
                     else inner.end_ms)
        series = select_raw_series(
            self.shards, raw.filters, fetch_start, fetch_end, raw.column,
            self.stats, full=True, limits=self.limits,
            margin_ms=inner.window_ms)
        params = RangeParams(inner.start_ms, inner.step_ms, inner.end_ms)
        res = None
        if series and not any(s.values.ndim == 2 for s in series):
            keys = [dict(s.labels) for s in series]
            gids, gkeys = _group_keys(keys, tuple(plan.by),
                                      tuple(plan.without))
            res = self.backend.fused_groupsum(
                series, inner.function, params.steps, inner.window_ms,
                inner.offset_ms, gids, len(gkeys))
        if res is not None:
            sums, cnts = res                       # [T, G]
            cnt = cnts.T.astype(np.float64)        # [G, T]
            with np.errstate(invalid="ignore", divide="ignore"):
                if plan.op == "sum":
                    out = sums.T.astype(np.float64)
                elif plan.op == "count":
                    out = cnt.copy()
                else:
                    out = sums.T.astype(np.float64) / cnt
            out = np.where(cnt == 0, np.nan, out)
            return GridResult(params.steps, gkeys, out)
        # general path over the already-selected series
        grid = None
        if self.backend is not None:
            grid = self.backend.periodic_samples(
                series, params, inner.function, inner.window_ms, (),
                inner.offset_ms)
        if grid is None:
            grid = periodic_samples(
                clip_series(series, fetch_start, fetch_end), params,
                inner.function, inner.window_ms, (), inner.offset_ms)
        return aggregate(grid, plan.op, (), tuple(plan.by),
                         tuple(plan.without))

    def _periodic(self, raw: lp.RawSeriesPlan, start_ms, step_ms, end_ms,
                  function, window_ms, func_args, offset_ms) -> GridResult:
        fetch_start = start_ms - window_ms - offset_ms
        fetch_end = end_ms - offset_ms if offset_ms else end_ms
        # only the counter evaluators read past the span (the margin)
        series = select_raw_series(
            self.shards, raw.filters, fetch_start, fetch_end, raw.column,
            self.stats, full=True, limits=self.limits,
            margin_ms=window_ms if function in _COUNTER_FUNCS else 0)
        params = RangeParams(start_ms, step_ms, end_ms)
        if self.backend is not None and function is not None:
            out = self.backend.periodic_samples(
                series, params, function, window_ms, func_args, offset_ms)
            if out is not None:
                return out
        # oracle fallback: evaluate only over the span the grid can touch
        return periodic_samples(clip_series(series, fetch_start, fetch_end),
                                params, function, window_ms,
                                func_args, offset_ms)

    def _at_pinned(self, raw: lp.RawSeriesPlan, at_ms: int, function,
                   window_ms, func_args, offset_ms, start_ms, step_ms,
                   end_ms) -> GridResult:
        """`@` modifier: evaluate the selector once at the pinned instant
        (window ends at at_ms - offset) and broadcast that value across the
        whole step grid — Prometheus @-modifier semantics. `_periodic`
        derives fetch bounds from its grid, so pinning the grid to [at_ms]
        also fetches the right data range even when at_ms lies far outside
        [start, end]."""
        one = self._periodic(raw, at_ms, 0, at_ms, function, window_ms,
                             func_args, offset_ms)
        steps = RangeParams(start_ms, step_ms, end_ms).steps
        values = np.repeat(one.values, steps.size, axis=1) \
            if one.num_series else np.zeros((0, steps.size))
        hv = None
        if one.is_hist():
            hv = np.repeat(one.hist_values, steps.size, axis=1)
        return GridResult(steps, one.keys, values, hist_values=hv,
                          bucket_les=one.bucket_les)

    def _subquery(self, plan: lp.SubqueryWithWindowing) -> GridResult:
        """func(expr[w:s]): evaluate inner on the subquery grid, then window
        over the inner steps (SubqueryWithWindowing semantics). With @ the
        subquery grid is pinned to at_ms and every outer step carries the
        pinned value (LogicalPlan.scala:349, ast/SubqueryUtils)."""
        steps = RangeParams(plan.start_ms, plan.step_ms, plan.end_ms).steps
        if plan.at_ms is not None:
            pin_end = plan.at_ms
            inner_start = pin_end - plan.window_ms - plan.offset_ms
            sub = lp_replace_range(plan.inner, inner_start,
                                   plan.sub_step_ms,
                                   pin_end - plan.offset_ms)
            inner = self._eval(sub)
            wend = np.array([pin_end - plan.offset_ms], dtype=np.int64)
            wstart = wend - plan.window_ms
            one = self._subquery_windows(plan, inner,
                                         np.array([pin_end]), wstart, wend)
            values = np.repeat(one.values, steps.size, axis=1)
            return GridResult(steps, one.keys, values)
        # the offset shifts which inner times the outer windows read:
        # the inner grid must cover [start - offset - window, end - offset]
        inner_start = plan.start_ms - plan.window_ms - plan.offset_ms
        inner_end = (plan.end_ms - plan.offset_ms if plan.offset_ms
                     else plan.end_ms)
        sub = lp_replace_range(plan.inner, inner_start, plan.sub_step_ms,
                               inner_end)
        inner = self._eval(sub)
        wend = steps - plan.offset_ms
        wstart = wend - plan.window_ms
        return self._subquery_windows(plan, inner, steps, wstart, wend)

    def _subquery_windows(self, plan, inner, steps, wstart, wend
                          ) -> GridResult:
        fn = rf.RANGE_FUNCTIONS.get(plan.function)
        if fn is None:
            raise QueryError(f"unknown range function {plan.function}")
        s1 = plan.func_args[0] if len(plan.func_args) > 0 else None
        s2 = plan.func_args[1] if len(plan.func_args) > 1 else None
        rows = []
        for i in range(inner.num_series):
            m = ~np.isnan(inner.values[i])
            rows.append(fn(inner.steps[m], inner.values[i][m], wstart, wend,
                           scalar=s1, scalar2=s2))
        values = np.vstack(rows) if rows else np.zeros((0, steps.size))
        return GridResult(steps, [dict(k) for k in inner.keys], values)


def lp_replace_range(plan, start_ms: int, step_ms: int, end_ms: int):
    """Rewrite a plan's evaluation range (used for subqueries and the
    raw/downsample tier split)."""
    import dataclasses
    if isinstance(plan, (lp.PeriodicSeries, lp.PeriodicSeriesWithWindowing)):
        # raw fetch bounds mirror the parser: the window AND the offset
        # shift what data a step can touch (promql/parser.py selector
        # materialization)
        raw = dataclasses.replace(
            plan.raw,
            start_ms=start_ms - _plan_window(plan) - plan.offset_ms,
            end_ms=end_ms - plan.offset_ms if plan.offset_ms else end_ms)
        return dataclasses.replace(plan, raw=raw, start_ms=start_ms,
                                   step_ms=step_ms, end_ms=end_ms)
    if isinstance(plan, (lp.Aggregate, lp.ApplyInstantFunction,
                         lp.ApplyMiscellaneousFunction, lp.ApplySortFunction,
                         lp.ApplyLimitFunction, lp.ScalarVaryingDoublePlan,
                         lp.ApplyAbsentFunction)):
        changes = {"inner": lp_replace_range(plan.inner, start_ms, step_ms,
                                             end_ms)}
        if isinstance(plan, lp.ApplyAbsentFunction):
            changes.update(start_ms=start_ms, step_ms=step_ms, end_ms=end_ms)
        return dataclasses.replace(plan, **changes)
    if isinstance(plan, lp.BinaryJoin):
        return dataclasses.replace(
            plan,
            lhs=lp_replace_range(plan.lhs, start_ms, step_ms, end_ms),
            rhs=lp_replace_range(plan.rhs, start_ms, step_ms, end_ms))
    if isinstance(plan, lp.ScalarVectorBinaryOperation):
        return dataclasses.replace(
            plan,
            scalar=lp_replace_range(plan.scalar, start_ms, step_ms, end_ms),
            vector=lp_replace_range(plan.vector, start_ms, step_ms, end_ms))
    if isinstance(plan, lp.SubqueryWithWindowing):
        # rebase the subquery's OUTER grid only; its inner expression is
        # rebased by _subquery at eval time from these bounds. Without
        # this case a NESTED subquery kept its parse-time grid and the
        # enclosing subquery windowed over a truncated inner range —
        # found by the promql differential rail (pinned:
        # test_pinned_nested_subquery_rebase)
        return dataclasses.replace(plan, start_ms=start_ms,
                                   step_ms=step_ms, end_ms=end_ms)
    if isinstance(plan, (lp.ScalarTimeBasedPlan, lp.ScalarFixedDoublePlan)):
        return dataclasses.replace(plan, start_ms=start_ms, step_ms=step_ms,
                                   end_ms=end_ms)
    if isinstance(plan, lp.ScalarBinaryOperation):
        def _side(x):
            return x if isinstance(x, (int, float)) else \
                lp_replace_range(x, start_ms, step_ms, end_ms)
        return dataclasses.replace(plan, lhs=_side(plan.lhs),
                                   rhs=_side(plan.rhs), start_ms=start_ms,
                                   step_ms=step_ms, end_ms=end_ms)
    if isinstance(plan, lp.VectorPlan):
        return dataclasses.replace(
            plan, scalar=lp_replace_range(plan.scalar, start_ms, step_ms,
                                          end_ms))
    return plan


def _plan_window(plan) -> int:
    if isinstance(plan, lp.PeriodicSeriesWithWindowing):
        return plan.window_ms
    if isinstance(plan, lp.PeriodicSeries):
        return plan.lookback_ms
    return 0


# ---------------------------------------------------------------------------
# Results-cache split / stitch (query/resultcache.py's evaluation core)
#
# The incremental range-query cache stores per-step matrix extents; a
# sliding-window dashboard re-issue splits into the cached extent and
# (at most) a head + tail of uncovered steps, each evaluated through the
# NORMAL pipeline via an lp_replace_range-rebased plan — the same
# rewrite the plan cache and the raw/downsample tier split rely on, so a
# sub-range evaluation is exactly what a fresh parse at that range would
# compute. Step values are per-step functions of the underlying samples
# (windows are anchored on the step, not the grid bounds), so columns
# computed under different grids are bit-identical and stitch losslessly.
# ---------------------------------------------------------------------------

def uncovered_spans(start_ms: int, step_ms: int, end_ms: int,
                    cov_lo_ms: int, cov_hi_ms: int
                    ) -> List[Tuple[int, int]]:
    """Split a requested step range [start, end] against a covered
    sub-range [cov_lo, cov_hi] (all step-aligned, cov within request):
    the 0-2 contiguous spans that must be recomputed. An empty/invalid
    coverage yields the whole request."""
    if cov_lo_ms > cov_hi_ms:
        return [(start_ms, end_ms)]
    spans: List[Tuple[int, int]] = []
    if cov_lo_ms > start_ms:
        spans.append((start_ms, cov_lo_ms - step_ms))
    if cov_hi_ms < end_ms:
        spans.append((cov_hi_ms + step_ms, end_ms))
    return spans


def assemble_stitched(steps: np.ndarray, cached_steps: np.ndarray,
                      cached_keys: Sequence[Mapping[str, str]],
                      cached_values: np.ndarray,
                      span_grids: Sequence[GridResult]
                      ) -> Tuple[GridResult, List[Dict[str, str]]]:
    """Assemble the full request grid from cached step columns plus
    freshly computed span grids, matching series identity by label set.

    Series keep the CACHED extent's order — selection order is stable
    across evaluations of the same data, so a fresh full-range compute
    enumerates the same series in the same order and the stitched
    response is byte-identical to it. A cached series absent from a
    computed span keeps NaN there (the span evaluation fetched back
    through the lookback window, so absence means a fresh compute would
    find no samples for those steps either — Prometheus staleness).

    Returns (grid, churn): ``churn`` lists series present in a computed
    span but ABSENT from the cached extent. Stitching cannot place them
    (their values at the cached steps are unknown — e.g. a new series
    whose backfill may even invalidate aggregated cached columns), so
    the caller computes-through: a full-range fresh evaluation replaces
    the stitch when churn is non-empty."""
    T = int(steps.size)
    key_ix = {tuple(sorted(k.items())): i
              for i, k in enumerate(cached_keys)}
    values = np.full((len(cached_keys), T), np.nan)
    if cached_steps.size:
        pos = np.searchsorted(steps, cached_steps)
        values[:, pos] = cached_values
    churn: List[Dict[str, str]] = []
    out = GridResult(steps, [dict(k) for k in cached_keys], values)
    for g in span_grids:
        if g.is_hist():
            # histogram grids never enter the cache; a span turning
            # hist means the world changed under us — compute through
            churn.append({"__hist__": "1"})
            continue
        gpos = np.searchsorted(steps, g.steps)
        for i, k in enumerate(g.keys):
            j = key_ix.get(tuple(sorted(k.items())))
            if j is None:
                churn.append(dict(k))
                continue
            values[j][gpos] = g.values[i]
        out.absorb_degraded(g)
    return out, churn
