"""Windowed range functions — numpy oracle backend.

Re-implements the reference's RangeFunction registry semantics
(query/exec/rangefn/RangeFunction.scala:235, InternalRangeFunction.scala:10,
RateFunctions.scala:10-79, AggrOverTimeFunctions.scala) in vectorized form:

For a periodic query (start, step, end) each output step ``t`` evaluates a
function over the window ``[t - window, t]`` (both ends inclusive — the
reference default ``filodb.query.inclusive-range = true``,
filodb-defaults.conf:336; PeriodicSamplesMapper.scala:215).

Instead of iterating rows per window, we compute for every window its sample
index range ``[lo, hi]`` with searchsorted, then evaluate functions from
prefix sums / gathered endpoints.  This is O(samples + windows) and data
parallel — the formulation the TPU backend compiles (see
filodb_tpu_torch.query.tpu).

All functions take timestamps in **milliseconds** and produce one value per
window; windows with insufficient samples yield NaN (Prometheus staleness
semantics).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Sequence

import numpy as np

from filodb_tpu_torch.memory.vectors import counter_correction


def window_bounds(ts: np.ndarray, wstart: np.ndarray, wend: np.ndarray):
    """Per-window index ranges [lo, hi] (inclusive) into sorted ``ts``.

    Mirrors WindowedChunkIterator + binary search row ranges
    (core/store/ChunkSetInfo.scala:432; RangeFunction.scala:122)."""
    lo = np.searchsorted(ts, wstart, side="left")
    hi = np.searchsorted(ts, wend, side="right") - 1
    return lo, hi


def _prep(ts: np.ndarray, vals: np.ndarray, drop_nan: bool = True):
    """Drop NaN (stale) samples — the reference's iterators skip NaNs
    (shouldInclude in sliding iterators)."""
    if drop_nan and vals.ndim == 1:
        m = ~np.isnan(vals)
        if not m.all():
            return ts[m], vals[m]
    return ts, vals


def extrapolated_rate(wstart, wend, counts, first_ts, first_val, last_ts,
                      last_val, is_counter: bool, is_rate: bool):
    """Vectorized Prometheus extrapolation
    (rangefn/RateFunctions.scala:37-76 extrapolatedRate).  All array args are
    per-window; returns per-window result with NaN where counts < 2."""
    counts = counts.astype(np.float64)
    with np.errstate(invalid="ignore", divide="ignore"):
        duration_to_start = (first_ts - wstart).astype(np.float64) / 1000.0
        duration_to_end = (wend - last_ts).astype(np.float64) / 1000.0
        sampled_interval = (last_ts - first_ts).astype(np.float64) / 1000.0
        avg_duration = sampled_interval / (counts - 1.0)
        delta = last_val - first_val

        if is_counter:
            # extrapolate only to the counter zero point
            duration_to_zero = np.where(
                (delta > 0) & (first_val >= 0),
                sampled_interval * (first_val / np.where(delta == 0, np.nan,
                                                         delta)),
                np.inf)
            duration_to_start = np.minimum(duration_to_start,
                                           duration_to_zero)

        threshold = avg_duration * 1.1
        extrap = sampled_interval \
            + np.where(duration_to_start < threshold, duration_to_start,
                       avg_duration / 2.0) \
            + np.where(duration_to_end < threshold, duration_to_end,
                       avg_duration / 2.0)
        scaled = delta * (extrap / sampled_interval)
        if is_rate:
            scaled = scaled / (wend - wstart) * 1000.0
        return np.where(counts >= 2, scaled, np.nan)


class RangeFunctionError(ValueError):
    pass


def _rate_family(is_counter: bool, is_rate: bool, need_correction: bool):
    def f(ts, vals, wstart, wend, **kw):
        ts, vals = _prep(ts, vals)
        if ts.size == 0:
            return np.full(wstart.shape, np.nan)
        corrected = vals + counter_correction(vals) if need_correction else vals
        lo, hi = window_bounds(ts, wstart, wend)
        counts = hi - lo + 1
        valid = counts >= 1
        lo_c = np.clip(lo, 0, ts.size - 1)
        hi_c = np.clip(hi, 0, ts.size - 1)
        out = extrapolated_rate(
            wstart, wend, counts,
            ts[lo_c], corrected[lo_c], ts[hi_c], corrected[hi_c],
            is_counter, is_rate)
        return np.where(valid, out, np.nan)
    return f


def _sum_family(reducer: str):
    """Prefix-sum based over-time aggregations
    (AggrOverTimeFunctions.scala chunked Sum/Count/Avg/StdDev/StdVar)."""
    def f(ts, vals, wstart, wend, **kw):
        ts, vals = _prep(ts, vals)
        n = ts.size
        nw = wstart.shape[0]
        if n == 0:
            if reducer == "count":
                return np.zeros(nw) * np.nan
            return np.full(nw, np.nan)
        lo, hi = window_bounds(ts, wstart, wend)
        counts = (hi - lo + 1).astype(np.float64)
        empty = counts <= 0
        cs = np.concatenate([[0.0], np.cumsum(vals)])
        s = cs[np.clip(hi + 1, 0, n)] - cs[np.clip(lo, 0, n)]
        with np.errstate(invalid="ignore", divide="ignore"):
            if reducer == "sum":
                out = s
            elif reducer == "count":
                out = counts
            elif reducer == "avg":
                out = s / counts
            else:
                # shifted squares: prefix sums of (x-c)^2 with c = series
                # mean keep full precision when |mean| >> stddev (Prometheus
                # computes this with Welford; the shifted prefix form is
                # algebraically identical and windowable)
                finite = vals[np.isfinite(vals)]
                shift = finite.mean() if finite.size else 0.0
                d = vals - shift
                cs2 = np.concatenate([[0.0], np.cumsum(d * d)])
                s2 = cs2[np.clip(hi + 1, 0, n)] - cs2[np.clip(lo, 0, n)]
                mean = s / counts
                dm = mean - shift
                var = np.maximum(s2 / counts - dm * dm, 0.0)
                if reducer == "stdvar":
                    out = var
                elif reducer == "stddev":
                    out = np.sqrt(var)
                elif reducer == "zscore":
                    hi_c = np.clip(hi, 0, n - 1)
                    out = (vals[hi_c] - mean) / np.sqrt(var)
                else:
                    raise RangeFunctionError(reducer)
        return np.where(empty, np.nan, out)
    return f


def _minmax_family(op: str):
    def f(ts, vals, wstart, wend, **kw):
        ts, vals = _prep(ts, vals)
        n = ts.size
        nw = wstart.shape[0]
        out = np.full(nw, np.nan)
        if n == 0:
            return out
        lo, hi = window_bounds(ts, wstart, wend)
        fn = np.minimum if op == "min" else np.maximum
        # reduceat over [lo, hi+1) slices: interleave boundaries
        for i in range(nw):
            if hi[i] >= lo[i]:
                seg = vals[lo[i] : hi[i] + 1]
                out[i] = seg.min() if op == "min" else seg.max()
        return out
    return f


def _last_sample(ts, vals, wstart, wend, **kw):
    """Instant-vector lookback: latest sample in window, NaN if none
    (PeriodicSamplesMapper default LastSampleFunction)."""
    # Do NOT drop NaNs: a NaN (stale marker) sample makes the series stale.
    n = ts.size
    out = np.full(wstart.shape, np.nan)
    if n == 0:
        return out
    hi = np.searchsorted(ts, wend, side="right") - 1
    valid = hi >= np.searchsorted(ts, wstart, side="left")
    hi_c = np.clip(hi, 0, n - 1)
    got = vals[hi_c]
    return np.where(valid, got, np.nan)


def _timestamp_fn(ts, vals, wstart, wend, **kw):
    ts, vals = _prep(ts, vals)
    n = ts.size
    out = np.full(wstart.shape, np.nan)
    if n == 0:
        return out
    lo, hi = window_bounds(ts, wstart, wend)
    valid = hi >= lo
    hi_c = np.clip(hi, 0, n - 1)
    return np.where(valid, ts[hi_c] / 1000.0, np.nan)


def _changes(ts, vals, wstart, wend, **kw):
    ts, vals = _prep(ts, vals)
    n = ts.size
    nw = wstart.shape[0]
    if n == 0:
        return np.full(nw, np.nan)
    changed = np.concatenate([[0.0], (np.diff(vals) != 0).astype(np.float64)])
    cs = np.concatenate([[0.0], np.cumsum(changed)])
    lo, hi = window_bounds(ts, wstart, wend)
    # changes between consecutive samples strictly inside the window:
    # count changed[i] for lo+1 <= i <= hi
    out = cs[np.clip(hi + 1, 0, n)] - cs[np.clip(lo + 1, 0, n)]
    return np.where(hi >= lo, out, np.nan)


def _resets(ts, vals, wstart, wend, **kw):
    ts, vals = _prep(ts, vals)
    n = ts.size
    nw = wstart.shape[0]
    if n == 0:
        return np.full(nw, np.nan)
    reset = np.concatenate([[0.0], (np.diff(vals) < 0).astype(np.float64)])
    cs = np.concatenate([[0.0], np.cumsum(reset)])
    lo, hi = window_bounds(ts, wstart, wend)
    out = cs[np.clip(hi + 1, 0, n)] - cs[np.clip(lo + 1, 0, n)]
    return np.where(hi >= lo, out, np.nan)


def _deriv_predict(predict: bool):
    """deriv() / predict_linear(): least-squares slope over the window
    (rangefn Deriv/PredictLinear; matches Prometheus simple regression)."""
    def f(ts, vals, wstart, wend, scalar=None, **kw):
        ts, vals = _prep(ts, vals)
        n = ts.size
        nw = wstart.shape[0]
        out = np.full(nw, np.nan)
        if n == 0:
            return out
        lo, hi = window_bounds(ts, wstart, wend)
        for i in range(nw):
            if hi[i] - lo[i] + 1 < 2:
                continue
            t = ts[lo[i] : hi[i] + 1].astype(np.float64) / 1000.0
            v = vals[lo[i] : hi[i] + 1]
            t0 = t - t[0]  # numerical stability (Prometheus does the same)
            tm, vm = t0.mean(), v.mean()
            cov = ((t0 - tm) * (v - vm)).sum()
            var = ((t0 - tm) ** 2).sum()
            if var == 0:
                continue
            slope = cov / var
            if predict:
                intercept = vm - slope * tm
                horizon = float(scalar) + (wend[i] / 1000.0 - t[0])
                out[i] = slope * horizon + intercept
            else:
                out[i] = slope
        return out
    return f


def _quantile_over_time(ts, vals, wstart, wend, scalar=None, **kw):
    ts, vals = _prep(ts, vals)
    q = float(scalar)
    nw = wstart.shape[0]
    out = np.full(nw, np.nan)
    if ts.size == 0:
        return out
    lo, hi = window_bounds(ts, wstart, wend)
    for i in range(nw):
        if hi[i] >= lo[i]:
            seg = vals[lo[i] : hi[i] + 1]
            out[i] = np.quantile(seg, min(max(q, 0.0), 1.0)) \
                if 0 <= q <= 1 else (np.inf if q > 1 else -np.inf)
    return out


def _mad_over_time(ts, vals, wstart, wend, **kw):
    ts, vals = _prep(ts, vals)
    nw = wstart.shape[0]
    out = np.full(nw, np.nan)
    if ts.size == 0:
        return out
    lo, hi = window_bounds(ts, wstart, wend)
    for i in range(nw):
        if hi[i] >= lo[i]:
            seg = vals[lo[i] : hi[i] + 1]
            med = np.median(seg)
            out[i] = np.median(np.abs(seg - med))
    return out


def _holt_winters(ts, vals, wstart, wend, scalar=None, scalar2=None, **kw):
    """holt_winters(v, sf, tf) — inherently sequential smoothing; looped
    oracle (rangefn HoltWinters)."""
    ts, vals = _prep(ts, vals)
    sf, tf = float(scalar), float(scalar2)
    nw = wstart.shape[0]
    out = np.full(nw, np.nan)
    if ts.size == 0 or not (0 < sf < 1) or not (0 < tf < 1):
        return out
    lo, hi = window_bounds(ts, wstart, wend)
    for i in range(nw):
        n = hi[i] - lo[i] + 1
        if n < 2:
            continue
        seg = vals[lo[i] : hi[i] + 1]
        s = seg[0]
        b = seg[1] - seg[0]
        for x in seg[1:]:
            s_prev = s
            s = sf * x + (1 - sf) * (s + b)
            b = tf * (s - s_prev) + (1 - tf) * b
        out[i] = s
    return out


def _absent_over_time(ts, vals, wstart, wend, **kw):
    ts, vals = _prep(ts, vals)
    if ts.size == 0:
        return np.ones(wstart.shape)
    lo, hi = window_bounds(ts, wstart, wend)
    return np.where(hi >= lo, np.nan, 1.0)


def _present_over_time(ts, vals, wstart, wend, **kw):
    ts, vals = _prep(ts, vals)
    if ts.size == 0:
        return np.full(wstart.shape, np.nan)
    lo, hi = window_bounds(ts, wstart, wend)
    return np.where(hi >= lo, 1.0, np.nan)


def _last_over_time(ts, vals, wstart, wend, **kw):
    ts, vals = _prep(ts, vals)
    return _last_sample(ts, vals, wstart, wend)


def _first_over_time(ts, vals, wstart, wend, **kw):
    ts, vals = _prep(ts, vals)
    n = ts.size
    out = np.full(wstart.shape, np.nan)
    if n == 0:
        return out
    lo, hi = window_bounds(ts, wstart, wend)
    lo_c = np.clip(lo, 0, n - 1)
    return np.where(hi >= lo, vals[lo_c], np.nan)


def _rate_over_delta(ts, vals, wstart, wend, **kw):
    """rate for delta-temporality counters = sum_over_time / window_seconds
    (RateFunctions.scala:331 RateOverDeltaChunkedFunctionD)."""
    s = _sum_family("sum")(ts, vals, wstart, wend)
    return s / (wend - wstart) * 1000.0


def _increase_over_delta(ts, vals, wstart, wend, **kw):
    return _sum_family("sum")(ts, vals, wstart, wend)


def _irate_idelta(is_rate: bool):
    def f(ts, vals, wstart, wend, **kw):
        ts, vals = _prep(ts, vals)
        n = ts.size
        out = np.full(wstart.shape, np.nan)
        if n < 2:
            return out
        lo, hi = window_bounds(ts, wstart, wend)
        ok = (hi >= lo + 1)
        hi_c = np.clip(hi, 1, n - 1)
        prev = hi_c - 1
        dv = vals[hi_c] - vals[prev]
        if is_rate:
            # counter reset handling: if drop, use raw last value
            dv = np.where(dv < 0, vals[hi_c], dv)
            dt = (ts[hi_c] - ts[prev]) / 1000.0
            res = dv / np.where(dt == 0, np.nan, dt)
        else:
            res = dv
        return np.where(ok, res, np.nan)
    return f


# Registry: InternalRangeFunction name -> implementation
# (exec/InternalRangeFunction.scala:10; PromQL surface names in comments)
RANGE_FUNCTIONS: Dict[str, Callable] = {
    "rate": _rate_family(True, True, True),
    "increase": _rate_family(True, False, True),
    "delta": _rate_family(False, False, False),
    "irate": _irate_idelta(True),
    "idelta": _irate_idelta(False),
    "sum_over_time": _sum_family("sum"),
    "count_over_time": _sum_family("count"),
    "avg_over_time": _sum_family("avg"),
    "stddev_over_time": _sum_family("stddev"),
    "stdvar_over_time": _sum_family("stdvar"),
    "z_score": _sum_family("zscore"),
    "min_over_time": _minmax_family("min"),
    "max_over_time": _minmax_family("max"),
    "last_over_time": _last_over_time,
    "first_over_time": _first_over_time,
    "changes": _changes,
    "resets": _resets,
    "deriv": _deriv_predict(False),
    "predict_linear": _deriv_predict(True),
    "quantile_over_time": _quantile_over_time,
    "mad_over_time": _mad_over_time,
    "holt_winters": _holt_winters,
    "absent_over_time": _absent_over_time,
    "present_over_time": _present_over_time,
    "timestamp": _timestamp_fn,
    "rate_over_delta": _rate_over_delta,
    "increase_over_delta": _increase_over_delta,
    "last_sample": _last_sample,   # instant selector w/ lookback
}

# functions that interpret the value column as a monotonic counter
COUNTER_FUNCTIONS = frozenset({"rate", "increase", "irate", "resets"})

# functions whose semantics assume a gauge: applying them to a counter
# silently ignores resets (promlint warns — semant.py schema family)
GAUGE_FUNCTIONS = frozenset({"delta", "idelta", "deriv"})

# scalar-parameter arity per range function beyond the range-vector arg
# (promlint arity checking; the parser's plan builder indexes args
# positionally and would IndexError without this pre-check)
RANGE_FN_SCALAR_ARITY: Dict[str, int] = {
    "quantile_over_time": 1, "z_score": 0, "mad_over_time": 0,
    "predict_linear": 1, "holt_winters": 2,
}


def evaluate(func: str, ts: np.ndarray, vals: np.ndarray,
             start_ms: int, step_ms: int, end_ms: int, window_ms: int,
             scalar: Optional[float] = None,
             scalar2: Optional[float] = None) -> np.ndarray:
    """Evaluate one range function for one series over a periodic step grid.

    Output step timestamps are start_ms, start_ms+step, ..., <= end_ms; each
    step t evaluates over [t - window, t] (inclusive-range default)."""
    steps = np.arange(start_ms, end_ms + 1, step_ms, dtype=np.int64)
    wend = steps
    wstart = steps - window_ms
    fn = RANGE_FUNCTIONS.get(func)
    if fn is None:
        raise RangeFunctionError(f"unknown range function: {func}")
    return fn(np.asarray(ts, dtype=np.int64),
              np.asarray(vals, dtype=np.float64),
              wstart, wend, scalar=scalar, scalar2=scalar2)


def step_grid(start_ms: int, step_ms: int, end_ms: int) -> np.ndarray:
    return np.arange(start_ms, end_ms + 1, step_ms, dtype=np.int64)
