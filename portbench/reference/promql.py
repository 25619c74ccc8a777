"""Plain NumPy reference of the PromQL range queries the benchmark's mixes
send, over the samples the benchmark generated. It imports nothing of the
program and reads nothing the server built.

Semantics (Prometheus, as FiloDB serves it):

  * a range query's steps are start, start + step, ... <= end (ms), and
    step t evaluates its function over the window [t - w, t], both ends
    inclusive (FiloDB's inclusive-range default);
  * `rate` / `increase` correct counter resets (a drop adds the value
    before it to every later sample) and extrapolate as Prometheus's
    extrapolatedRate does: towards the window's edges by at most 1.1
    average sample gaps (half a gap otherwise), a counter never below
    zero; a window with fewer than two samples has no value;
  * `avg_over_time`, `sum_over_time`, `count_over_time`, `max_over_time`,
    `min_over_time` over the samples in the window; none in it: no value;
  * the range function drops the metric name, so `by (__name__)` groups
    every series into one;
  * `sum`, `avg`, `count`, `max`, `min` `by (labels)`, the clause before
    or after the operand, over the series that have a value at the step;
    a group with none has no value there.

`dtype` sets the precision of every floating-point operation: float64 is
the reference, float32 the benchmark's control (the step below float64).
Timestamps stay integer milliseconds either way.
"""

from __future__ import annotations

import re
from typing import Dict, List, Sequence, Tuple

import numpy as np

_DUR_MS = {"ms": 1, "s": 1000, "m": 60_000, "h": 3_600_000, "d": 86_400_000}
AGGREGATIONS = ("sum", "avg", "count", "max", "min")
FUNCTIONS = ("rate", "increase", "avg_over_time", "sum_over_time",
             "count_over_time", "max_over_time", "min_over_time")

_AGG_RES = (
    re.compile(r"^\s*(?P<agg>[a-z]+)\s+by\s*\((?P<by>[^)]*)\)\s*"
               r"\((?P<inner>.*)\)\s*$"),
    re.compile(r"^\s*(?P<agg>[a-z]+)\s*\((?P<inner>.*)\)\s*"
               r"by\s*\((?P<by>[^)]*)\)\s*$"))
_INNER_RE = re.compile(
    r"^\s*(?P<func>[a-z_]+)\s*\(\s*(?P<sel>[^\[]*)\[(?P<dur>\d+)"
    r"(?P<unit>ms|s|m|h|d)\]\s*\)\s*$")
_MATCHER_RE = re.compile(
    r'\s*([A-Za-z_][A-Za-z0-9_]*)\s*(=~|!~|!=|=)\s*'
    r'(?:"((?:[^"\\]|\\.)*)"|\'((?:[^\'\\]|\\.)*)\')\s*,?')


class Query:
    """A parsed query: an optional aggregation `agg by (by)` around
    `func(selector[window])`."""

    def __init__(self, agg, by, func, window_ms, matchers):
        self.agg: str = agg
        self.by: Tuple[str, ...] = by
        self.func: str = func
        self.window_ms: int = window_ms
        self.matchers: List[Tuple[str, str, str]] = matchers


def parse(promql: str) -> Query:
    agg, by, inner = None, (), promql
    m = next((m for m in (r.match(promql) for r in _AGG_RES) if m), None)
    if m:
        agg = m.group("agg")
        if agg not in AGGREGATIONS:
            raise ValueError(f"aggregation {agg!r} is not in the reference")
        by = tuple(x.strip() for x in m.group("by").split(",") if x.strip())
        inner = m.group("inner")
    m = _INNER_RE.match(inner)
    if not m:
        raise ValueError(f"query form not in the reference: {promql!r}")
    func = m.group("func")
    if func not in FUNCTIONS:
        raise ValueError(f"function {func!r} is not in the reference")
    window_ms = int(m.group("dur")) * _DUR_MS[m.group("unit")]
    sel = m.group("sel").strip()
    matchers = []
    name, _, rest = sel.partition("{")
    if name.strip():
        matchers.append(("__name__", "=", name.strip()))
    body = rest.rstrip().rstrip("}") if rest else ""
    pos = 0
    while pos < len(body):
        mm = _MATCHER_RE.match(body, pos)
        if not mm:
            raise ValueError(f"bad selector {sel!r}")
        value = mm.group(3) if mm.group(3) is not None else mm.group(4)
        matchers.append((mm.group(1), mm.group(2),
                         value.encode().decode("unicode_escape")))
        pos = mm.end()
    return Query(agg, by, func, window_ms, matchers)


def select(labels: Sequence[Dict[str, str]], matchers) -> np.ndarray:
    """Indices of the series whose labels satisfy every matcher (regexes
    anchored at both ends, a missing label reading as "")."""
    compiled = [(k, op, re.compile(v) if op in ("=~", "!~") else v)
                for k, op, v in matchers]
    out = []
    for i, lab in enumerate(labels):
        ok = True
        for k, op, v in compiled:
            x = lab.get(k, "")
            if op == "=":
                ok = x == v
            elif op == "!=":
                ok = x != v
            elif op == "=~":
                ok = v.fullmatch(x) is not None
            else:
                ok = v.fullmatch(x) is None
            if not ok:
                break
        if ok:
            out.append(i)
    return np.asarray(out, dtype=np.int64)


def steps_ms(start_s: int, end_s: int, step_s: int) -> np.ndarray:
    return np.arange(start_s * 1000, end_s * 1000 + 1, step_s * 1000,
                     dtype=np.int64)


def _search(ts: np.ndarray, rows: np.ndarray, t: np.ndarray,
            right: bool) -> np.ndarray:
    """[k, T]: for each row r of ts[rows] (sorted) and each time t, the
    first index whose sample is >= t (> t when `right`), as searchsorted
    gives it. Starts from a linear guess along each row and steps one
    index at a time until the answer holds, so samples of near-regular
    cadence take a few passes."""
    n = ts.shape[1]
    flat = ts.ravel()
    base = (rows * n)[:, None]
    t = t[None, :]
    first, last = flat[base], flat[base + n - 1]
    guess = (t - first) * (n - 1) / np.maximum(last - first, 1)
    idx = np.clip(np.rint(guess), 0, n).astype(np.int64)
    while True:
        below = flat.take(base + np.maximum(idx - 1, 0))
        at = flat.take(base + np.minimum(idx, n - 1))
        if right:
            down = (idx > 0) & (below > t)
            up = (idx < n) & (at <= t)
        else:
            down = (idx > 0) & (below >= t)
            up = (idx < n) & (at < t)
        if not (down.any() or up.any()):
            return idx
        idx += up
        idx -= down


def window_bounds(ts: np.ndarray, rows: np.ndarray, wstart: np.ndarray,
                  wend: np.ndarray):
    """[k, T] first index with ts >= wstart and last with ts <= wend in each
    row of ts[rows]."""
    return (_search(ts, rows, wstart, right=False),
            _search(ts, rows, wend, right=True) - 1)


def corrected(vals: np.ndarray) -> np.ndarray:
    """Counter values with resets corrected: each drop adds the value
    before it to every later sample."""
    drops = np.where(vals[:, 1:] < vals[:, :-1], vals[:, :-1],
                     np.zeros((), vals.dtype))
    corr = np.zeros_like(vals)
    np.cumsum(drops, axis=1, out=corr[:, 1:])
    return vals + corr


def _rate(ts, cv, rows, wstart, wend, is_rate: bool, dt):
    """cv: every row's reset-corrected values in dt."""
    lo, hi = window_bounds(ts, rows, wstart, wend)
    n = ts.shape[1]
    cnt = hi - lo + 1
    base = (rows * n)[:, None]
    lo_c = base + np.clip(lo, 0, n - 1)
    hi_c = base + np.clip(hi, 0, n - 1)
    t1, t2 = ts.ravel().take(lo_c), ts.ravel().take(hi_c)
    v1, v2 = cv.ravel().take(lo_c), cv.ravel().take(hi_c)
    ms = dt(1000.0)
    with np.errstate(invalid="ignore", divide="ignore"):
        to_start = (t1 - wstart[None, :]).astype(dt) / ms
        to_end = (wend[None, :] - t2).astype(dt) / ms
        sampled = (t2 - t1).astype(dt) / ms
        avg_gap = sampled / (cnt.astype(dt) - dt(1.0))
        delta = v2 - v1
        to_zero = np.where((delta > 0) & (v1 >= 0),
                           sampled * (v1 / np.where(delta == 0, dt(np.nan),
                                                    delta)),
                           dt(np.inf))
        to_start = np.minimum(to_start, to_zero)
        limit = avg_gap * dt(1.1)
        half = avg_gap / dt(2.0)
        extrap = (sampled + np.where(to_start < limit, to_start, half)
                  + np.where(to_end < limit, to_end, half))
        out = delta * (extrap / sampled)
        if is_rate:
            out = out / ((wend - wstart).astype(dt) / ms)[None, :]
    return np.where(cnt >= 2, out, dt(np.nan))


def _window_sum(vals, lo, hi, dt):
    n = vals.shape[1]
    cs = np.zeros((vals.shape[0], n + 1), dt)
    np.cumsum(vals, axis=1, out=cs[:, 1:])
    a = np.take_along_axis(cs, np.clip(lo, 0, n), 1)
    b = np.take_along_axis(cs, np.clip(hi + 1, 0, n), 1)
    return b - a


def _window_extreme(vals, lo, hi, op):
    """Max or min of vals[r, lo:hi+1] for every window, by a sparse table
    of power-of-two blocks."""
    k, n = vals.shape
    table = [vals]
    width = 1
    while 2 * width <= n:
        prev = table[-1]
        table.append(op(prev[:, :n - 2 * width + 1],
                        prev[:, width:n - width + 1]))
        width *= 2
    lo_c = np.clip(lo, 0, n - 1)
    length = np.maximum(hi - lo + 1, 1)
    level = np.floor(np.log2(length)).astype(np.int64)
    out = np.empty(lo.shape, vals.dtype)
    for lv in np.unique(level):
        m = level == lv
        tab = table[lv]
        rows = np.nonzero(m)[0]
        a = tab[rows, np.clip(lo_c[m], 0, tab.shape[1] - 1)]
        b = tab[rows, np.clip(hi[m] - (1 << lv) + 1, 0, tab.shape[1] - 1)]
        out[m] = op(a, b)
    return out


def range_function(func: str, data: "Series", rows: np.ndarray,
                   steps: np.ndarray, window_ms: int, dt) -> np.ndarray:
    """[k, T] values of `func` for the series data[rows]; NaN where a
    window has no value."""
    wend = steps
    wstart = steps - window_ms
    if func in ("rate", "increase"):
        return _rate(data.ts, data.corrected(dt), rows, wstart, wend,
                     func == "rate", dt)
    lo, hi = window_bounds(data.ts, rows, wstart, wend)
    vals = data.vals[rows].astype(dt)
    cnt = hi - lo + 1
    empty = cnt <= 0
    with np.errstate(invalid="ignore", divide="ignore"):
        if func == "count_over_time":
            out = cnt.astype(dt)
        elif func in ("sum_over_time", "avg_over_time"):
            out = _window_sum(vals, lo, hi, dt)
            if func == "avg_over_time":
                out = out / cnt.astype(dt)
        elif func == "max_over_time":
            out = _window_extreme(vals, lo, hi, np.maximum)
        elif func == "min_over_time":
            out = _window_extreme(vals, lo, hi, np.minimum)
        else:
            raise ValueError(func)
    return np.where(empty, dt(np.nan), out)


def _aggregate(agg: str, v: np.ndarray, dt) -> np.ndarray:
    have = ~np.isnan(v)
    n = have.sum(axis=0)
    with np.errstate(invalid="ignore", divide="ignore"):
        if agg == "count":
            out = n.astype(dt)
        elif agg in ("sum", "avg"):
            out = np.where(have, v, dt(0.0)).sum(axis=0, dtype=dt)
            if agg == "avg":
                out = out / n.astype(dt)
        elif agg == "max":
            out = np.where(have, v, dt(-np.inf)).max(axis=0)
        else:
            out = np.where(have, v, dt(np.inf)).min(axis=0)
    return np.where(n > 0, out, dt(np.nan))


class Series:
    """The samples the queries read: labels[i] (with __name__), ts[i]
    (int ms, sorted) and vals[i] for every series i, ts and vals [S, N];
    each precision's reset-corrected values are worked out once."""

    def __init__(self, labels: Sequence[Dict[str, str]], ts: np.ndarray,
                 vals: np.ndarray):
        self.labels, self.ts, self.vals = labels, ts, vals
        self._corrected: Dict = {}

    def corrected(self, dt) -> np.ndarray:
        if dt not in self._corrected:
            self._corrected[dt] = corrected(self.vals.astype(dt))
        return self._corrected[dt]

    def evaluate(self, promql: str, start_s: int, end_s: int, step_s: int,
                 dtype=np.float64
                 ) -> Dict[Tuple[Tuple[str, str], ...], np.ndarray]:
        """The answer of one range query as {sorted label pairs (without
        __name__): [T] values, NaN where the answer has no sample}."""
        q = parse(promql)
        dt = np.dtype(dtype).type
        steps = steps_ms(start_s, end_s, step_s)
        idx = select(self.labels, q.matchers)
        if idx.size == 0:
            return {}
        grid = range_function(q.func, self, idx, steps, q.window_ms, dt)
        groups: Dict[Tuple, List[int]] = {}
        for row, i in enumerate(idx):
            lab = self.labels[i]
            key = (tuple(sorted((k, lab[k]) for k in q.by
                                if k in lab and k != "__name__"))
                   if q.agg else
                   tuple(sorted((k, v) for k, v in lab.items()
                                if k != "__name__")))
            groups.setdefault(key, []).append(row)
        out = {}
        for key, rows in groups.items():
            if not q.agg and len(rows) > 1:
                raise ValueError(f"{promql!r}: two series share the labels "
                                 f"{dict(key)} once __name__ is dropped")
            v = _aggregate(q.agg, grid[rows], dt) if q.agg else grid[rows[0]]
            if not np.isnan(v).all():
                out[key] = v
        return out
