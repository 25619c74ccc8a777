"""Deliberately slow, obviously-correct pure-Python PromQL reference
evaluator.

The engine (:mod:`filodb_tpu_torch.query.engine` + the device backends)
evaluates dense ``[series, steps]`` grids with vectorized prefix sums,
searchsorted window bounds, and fused device kernels — fast, but every
one of those transformations is a chance to drift from the semantics.
This module is the other arm of the differential rail: it evaluates the
SAME parsed AST with nothing but per-step Python loops over ``(ts,
value)`` sample lists, written to be auditable line-by-line against the
Prometheus semantics (inclusive windows, staleness lookback,
extrapolated rates with counter-reset correction, NaN propagation).

``tests/test_torch_promql_differential.py`` runs generated well-typed
queries (:mod:`filodb_tpu_torch.promql.gen`) through the real engine (its
device routes and the results cache) and through this evaluator; any
numeric discrepancy is a bug in one of them and lands as a pinned
regression test. ``ref_eval``'s ``extrapolate`` and ``arith`` hooks let
that soak evaluate the same query with another window rule (a knife
edge's other branch) or other operators (the magnitudes its tolerances
scale with); by default they are the Prometheus semantics.

Scope: the generator's surface — selectors, the rate/over_time range
families, subqueries, sum/avg/min/max/count/group/stddev/stdvar
aggregations with by/without, topk/bottomk (per-step top-k selection
keeping the member series), scalar and vector binary operators
(incl. bool / filtering comparisons, and/or/unless, and
group_left/group_right many-to-one joins with include labels), the
pure instant functions, classic-bucket ``histogram_quantile`` (the
`le`-series join with Prometheus bucket interpolation), offsets,
scalar()/vector()/time(). sort/label_replace, native-histogram
columns and @-pinning remain engine-test territory.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

from filodb_tpu_torch.promql import parser as pp

NAN = float("nan")
INF = float("inf")

DEFAULT_LOOKBACK_MS = pp.DEFAULT_LOOKBACK_MS

_METRIC_LABELS = ("_metric_", "__name__")


class RefEvalError(Exception):
    """The reference evaluator hit a case outside its scope or an
    eval-time semantic error (many-to-many match, unknown function)."""


@dataclass
class RefSeries:
    """One input series: labels + sorted (ts_ms, value) samples."""
    labels: Dict[str, str]
    ts: List[int]
    values: List[float]


def _strip_metric(labels: Mapping[str, str]) -> Dict[str, str]:
    return {k: v for k, v in labels.items() if k not in _METRIC_LABELS}


def _key(labels: Mapping[str, str]) -> Tuple:
    return tuple(sorted(labels.items()))


@dataclass
class _Vec:
    """Instant-vector value: per-series rows on the shared step grid."""
    rows: List[Tuple[Dict[str, str], List[float]]] \
        = field(default_factory=list)


def _isnan(x: float) -> bool:
    return x != x


# ---------------------------------------------------------------------------
# scalar math with IEEE/numpy semantics
# ---------------------------------------------------------------------------

def _div(a: float, b: float) -> float:
    if _isnan(a) or _isnan(b):
        return NAN
    if b == 0.0:
        if a == 0.0:
            return NAN
        return math.copysign(INF, a) * math.copysign(1.0, b)
    try:
        return a / b
    except OverflowError:
        return math.copysign(INF, a) * math.copysign(1.0, b)


def _fmod(a: float, b: float) -> float:
    if _isnan(a) or _isnan(b) or b == 0.0 or math.isinf(a):
        return NAN
    return math.fmod(a, b)


def _pow(a: float, b: float) -> float:
    if _isnan(a) or _isnan(b):
        # numpy: 1 ** nan == 1, nan ** 0 == 1
        if a == 1.0:
            return 1.0
        if b == 0.0:
            return 1.0
        return NAN
    if a == 0.0 and b < 0:
        return INF
    try:
        return math.pow(a, b)
    except ValueError:          # (-8) ** 0.5 -> nan (numpy semantics)
        return NAN
    except OverflowError:
        odd_neg = a < 0 and float(b).is_integer() and int(b) % 2 == 1
        return -INF if odd_neg else INF


_ARITH = {
    "+": lambda a, b: a + b if not (_isnan(a) or _isnan(b)) else NAN,
    "-": lambda a, b: a - b if not (_isnan(a) or _isnan(b)) else NAN,
    "*": lambda a, b: a * b if not (_isnan(a) or _isnan(b)) else NAN,
    "/": _div,
    "%": _fmod,
    "^": _pow,
    "atan2": lambda a, b: NAN if (_isnan(a) or _isnan(b))
    else math.atan2(a, b),
}

_COMP = {
    "==": lambda a, b: a == b, "!=": lambda a, b: a != b,
    ">": lambda a, b: a > b, "<": lambda a, b: a < b,
    ">=": lambda a, b: a >= b, "<=": lambda a, b: a <= b,
}


def _apply_op(op: str, a: float, b: float, return_bool: bool,
              keep: Optional[float] = None,
              arith: Mapping[str, Callable] = _ARITH) -> float:
    """One sample of the engine's ``_apply_op``. ``keep`` is the value
    a filtering comparison retains (the VECTOR side's sample; defaults
    to ``a`` — the engine's vector-vector join semantics). ``arith``
    maps each arithmetic operator to its function."""
    if op in arith:
        # mirror numpy: inf - inf = nan, 0 * inf = nan arise naturally
        try:
            return arith[op](a, b)
        except OverflowError:
            return INF
    if op in _COMP:
        if return_bool:
            if _isnan(a) or _isnan(b):
                return NAN
            return 1.0 if _COMP[op](a, b) else 0.0
        m = (not _isnan(a)) and (not _isnan(b)) and _COMP[op](a, b)
        return (a if keep is None else keep) if m else NAN
    raise RefEvalError(f"unknown binary op {op}")


# ---------------------------------------------------------------------------
# windowed range functions — per-window sample-list loops
# ---------------------------------------------------------------------------

def _in_window(ts: List[int], vals: List[float], ws: int, we: int
               ) -> Tuple[List[int], List[float]]:
    ot, ov = [], []
    for t, v in zip(ts, vals):
        if ws <= t <= we:       # inclusive both ends (reference default)
            ot.append(t)
            ov.append(v)
    return ot, ov


def _drop_nan(ts: List[int], vals: List[float]
              ) -> Tuple[List[int], List[float]]:
    ot, ov = [], []
    for t, v in zip(ts, vals):
        if not _isnan(v):
            ot.append(t)
            ov.append(v)
    return ot, ov


def _corrected(vals: List[float]) -> List[float]:
    """Counter-reset corrected values (memory.vectors.counter_correction
    semantics over an already NaN-free list): each drop adds the
    pre-drop value to every later sample."""
    out = []
    corr = 0.0
    prev = None
    for v in vals:
        if prev is not None and v < prev:
            corr += prev
        out.append(v + corr)
        prev = v
    return out


def _edge(gap: float, threshold: float, avg_duration: float,
          knife_s: Optional[float]) -> float:
    """The extrapolation taken at one window edge: the gap itself below
    the threshold, else half the average interval; with ``knife_s``,
    the other branch wherever the gap is within ``knife_s`` of the
    threshold."""
    take = gap < threshold
    if knife_s is not None and abs(gap - threshold) <= knife_s:
        take = not take
    return gap if take else avg_duration / 2.0


def _extrapolated(ws: int, we: int, sts: List[int], svs: List[float],
                  is_counter: bool, is_rate: bool,
                  knife_s: Optional[float] = None) -> float:
    """Prometheus extrapolation (RateFunctions.scala extrapolatedRate),
    one window at a time. ``svs`` are already reset-corrected.
    ``knife_s`` flips the branch of an edge within that many seconds of
    its threshold (``_edge``)."""
    if len(sts) < 2:
        return NAN
    first_ts, first_val = sts[0], svs[0]
    last_ts, last_val = sts[-1], svs[-1]
    duration_to_start = (first_ts - ws) / 1000.0
    duration_to_end = (we - last_ts) / 1000.0
    sampled_interval = (last_ts - first_ts) / 1000.0
    if sampled_interval == 0:
        return NAN
    avg_duration = sampled_interval / (len(sts) - 1)
    delta = last_val - first_val
    if is_counter and delta > 0 and first_val >= 0:
        duration_to_zero = sampled_interval * (first_val / delta)
        duration_to_start = min(duration_to_start, duration_to_zero)
    threshold = avg_duration * 1.1
    extrap = sampled_interval \
        + _edge(duration_to_start, threshold, avg_duration, knife_s) \
        + _edge(duration_to_end, threshold, avg_duration, knife_s)
    scaled = delta * (extrap / sampled_interval)
    if is_rate:
        scaled = scaled / (we - ws) * 1000.0
    return scaled


def _mean(xs: List[float]) -> float:
    return sum(xs) / len(xs)


def _variance(xs: List[float]) -> float:
    m = _mean(xs)
    return max(sum((x - m) ** 2 for x in xs) / len(xs), 0.0)


def eval_range_fn(func: str, ts: List[int], vals: List[float],
                  ws: int, we: int,
                  extrapolate: Callable = _extrapolated) -> float:
    """One range function over one window of one series. ``ts``/``vals``
    are the series' full (clipped) samples; correction for the rate
    family accumulates from the start of the clipped span, exactly like
    the engine applies ``counter_correction`` to the clipped array.
    ``extrapolate`` computes the rate family's windows."""
    if func == "last_sample":
        # instant lookback: NaN (stale-marker) samples are NOT dropped
        last = None
        for t, v in zip(ts, vals):
            if ws <= t <= we:
                last = v
        return NAN if last is None else last
    cts, cvs = _drop_nan(ts, vals)
    if func in ("rate", "increase", "delta"):
        use = _corrected(cvs) if func != "delta" else cvs
        sts, svs = _in_window(cts, use, ws, we)
        return extrapolate(ws, we, sts, svs, func != "delta",
                           func == "rate")
    sts, svs = _in_window(cts, cvs, ws, we)
    n = len(sts)
    if func in ("irate", "idelta"):
        if n < 2:
            return NAN
        dv = svs[-1] - svs[-2]
        if func == "idelta":
            return dv
        if dv < 0:
            dv = svs[-1]        # counter reset: raw last value
        dt = (sts[-1] - sts[-2]) / 1000.0
        return NAN if dt == 0 else dv / dt
    if func == "present_over_time":
        return 1.0 if n else NAN
    if n == 0:
        return NAN
    if func == "sum_over_time":
        return sum(svs)
    if func == "count_over_time":
        return float(n)
    if func == "avg_over_time":
        return _mean(svs)
    if func == "min_over_time":
        return min(svs)
    if func == "max_over_time":
        return max(svs)
    if func == "last_over_time":
        return svs[-1]
    if func == "first_over_time":
        return svs[0]
    if func == "stddev_over_time":
        return math.sqrt(_variance(svs))
    if func == "stdvar_over_time":
        return _variance(svs)
    if func == "changes":
        return float(sum(1 for i in range(1, n)
                         if svs[i] != svs[i - 1]))
    if func == "resets":
        return float(sum(1 for i in range(1, n)
                         if svs[i] < svs[i - 1]))
    if func == "deriv":
        return _linreg(sts, svs)[0]
    raise RefEvalError(f"range function {func} outside refeval scope")


def _linreg(sts: List[int], svs: List[float]) -> Tuple[float, float]:
    """Least-squares slope/intercept over (seconds-since-first, value)
    (the engine's _deriv_predict loop)."""
    if len(sts) < 2:
        return NAN, NAN
    t = [(x / 1000.0) for x in sts]
    t0 = [x - t[0] for x in t]
    tm = _mean(t0)
    vm = _mean(svs)
    cov = sum((a - tm) * (b - vm) for a, b in zip(t0, svs))
    var = sum((a - tm) ** 2 for a in t0)
    if var == 0:
        return NAN, NAN
    slope = cov / var
    return slope, vm - slope * tm


# ---------------------------------------------------------------------------
# instant functions
# ---------------------------------------------------------------------------

def _round_engine(v: float, to_nearest: float) -> float:
    if _isnan(v):
        return NAN
    return math.floor(v / to_nearest + 0.5) * to_nearest


def eval_instant_fn(func: str, v: float, args: Sequence[float]) -> float:
    if func == "round":
        return _round_engine(v, float(args[0]) if args else 1.0)
    if func == "clamp":
        lo, hi = float(args[0]), float(args[1])
        return NAN if _isnan(v) else min(max(v, lo), hi)
    if func == "clamp_min":
        return NAN if _isnan(v) else max(v, float(args[0]))
    if func == "clamp_max":
        return NAN if _isnan(v) else min(v, float(args[0]))
    if _isnan(v):
        return NAN
    if func == "abs":
        return abs(v)
    if func == "ceil":
        return float(math.ceil(v)) if not math.isinf(v) else v
    if func == "floor":
        return float(math.floor(v)) if not math.isinf(v) else v
    if func == "sqrt":
        return math.sqrt(v) if v >= 0 else NAN
    if func == "exp":
        try:
            return math.exp(v)
        except OverflowError:
            return INF
    if func == "ln":
        return math.log(v) if v > 0 else (-INF if v == 0 else NAN)
    if func == "sgn":
        return 0.0 if v == 0 else math.copysign(1.0, v)
    raise RefEvalError(f"instant function {func} outside refeval scope")


def _bucket_quantile(q: float, les: List[float],
                     cum: List[float]) -> float:
    """Prometheus bucketQuantile over one cumulative histogram column
    (pure-Python mirror of memory/histogram.quantile — the engine's
    bucket math — audited against Histogram.scala:17)."""
    if not 0 <= q <= 1:
        return INF if q > 1 else -INF
    if len(les) < 2:
        return NAN
    total = cum[-1]
    if total == 0 or _isnan(total):
        return NAN
    rank = q * total
    b = 0                               # searchsorted(cum, rank, 'left')
    while b < len(cum) and cum[b] < rank:
        b += 1
    b = min(b, len(les) - 1)
    if b == len(les) - 1:
        return float(les[-2])
    if b == 0 and les[0] <= 0:
        return float(les[0])
    bucket_start = 0.0 if b == 0 else float(les[b - 1])
    bucket_end = float(les[b])
    count_start = 0.0 if b == 0 else float(cum[b - 1])
    count_end = float(cum[b])
    if count_end == count_start:
        return bucket_end
    return bucket_start + (bucket_end - bucket_start) * \
        (rank - count_start) / (count_end - count_start)


# ---------------------------------------------------------------------------
# the evaluator
# ---------------------------------------------------------------------------

class RefEvaluator:
    def __init__(self, series: Sequence[RefSeries], start_s: int,
                 step_s: int, end_s: int,
                 lookback_ms: int = DEFAULT_LOOKBACK_MS,
                 extrapolate: Callable = _extrapolated,
                 arith: Mapping[str, Callable] = _ARITH):
        self.series = list(series)
        self.extrapolate = extrapolate
        self.arith = arith
        self.start_ms = start_s * 1000
        self.step_ms = max(step_s, 1) * 1000
        self.end_ms = end_s * 1000
        self.lookback_ms = lookback_ms
        self.grid = list(range(self.start_ms, self.end_ms + 1,
                               self.step_ms))

    def _op(self, op: str, a: float, b: float, return_bool: bool,
            keep: Optional[float] = None) -> float:
        return _apply_op(op, a, b, return_bool, keep, self.arith)

    def _window(self, func: str, ts: List[int], vals: List[float],
                ws: int, we: int) -> float:
        return eval_range_fn(func, ts, vals, ws, we, self.extrapolate)

    # -- selection -------------------------------------------------------
    def _match(self, sel: pp.Selector, labels: Mapping[str, str]) -> bool:
        if sel.metric is not None and \
                labels.get("_metric_") != sel.metric:
            return False
        for m in sel.matchers:
            lbl = "_metric_" if m.label == "__name__" else m.label
            val = labels.get(lbl, "")
            if m.op == "=":
                if val != m.value:
                    return False
            elif m.op == "!=":
                if val == m.value:
                    return False
            elif m.op == "=~":
                if re.fullmatch(m.value, val) is None:
                    return False
            elif m.op == "!~":
                if re.fullmatch(m.value, val) is not None:
                    return False
        return True

    def _select(self, sel: pp.Selector) -> List[RefSeries]:
        return [s for s in self.series if self._match(sel, s.labels)]

    # -- entry -----------------------------------------------------------
    def eval(self, node) -> _Vec:
        out = self._eval(node, self.grid)
        if isinstance(out, _Vec):
            return out
        # bare scalar expression: the engine returns a ScalarResult;
        # surface it as one anonymous row for comparison
        return _Vec([({}, out)])

    def _eval(self, node, grid: List[int]):
        """-> _Vec or List[float] (scalar-per-step) or str."""
        if isinstance(node, pp.NumLit):
            return [node.value] * len(grid)
        if isinstance(node, pp.StrLit):
            return node.value
        if isinstance(node, pp.Unary):
            inner = self._eval(node.expr, grid)
            if isinstance(inner, _Vec):
                return _Vec([(_strip_metric(l),
                              [self._op("-", 0.0, v, False)
                               for v in row])
                             for l, row in inner.rows])
            return [self._op("-", 0.0, v, False) for v in inner]
        if isinstance(node, pp.Selector):
            if node.window_ms is not None:
                raise RefEvalError("bare range vector")
            return self._instant_selector(node, grid)
        if isinstance(node, pp.Call):
            return self._call(node, grid)
        if isinstance(node, pp.Agg):
            return self._agg(node, grid)
        if isinstance(node, pp.BinOp):
            return self._binop(node, grid)
        raise RefEvalError(f"node {type(node).__name__} outside scope")

    # -- selectors -------------------------------------------------------
    def _instant_selector(self, sel: pp.Selector, grid: List[int]
                          ) -> _Vec:
        rows = []
        off = sel.offset_ms
        for s in self._select(sel):
            vals = []
            for t in grid:
                we = t - off
                ws = we - self.lookback_ms
                vals.append(self._window("last_sample", s.ts, s.values,
                                          ws, we))
            rows.append((dict(s.labels), vals))
        return _Vec(rows)

    def _range_series(self, sel: pp.Selector, grid: List[int],
                      func: str) -> _Vec:
        """Range function over a [window] selector: samples clipped to
        the engine's fetch span so rate-family correction accumulates
        over the same prefix."""
        rows = []
        w = sel.window_ms
        off = sel.offset_ms
        clip_lo = grid[0] - w - off
        clip_hi = grid[-1] - off if off else grid[-1]
        for s in self._select(sel):
            ts, vs = [], []
            for t, v in zip(s.ts, s.values):
                if clip_lo <= t <= clip_hi:
                    ts.append(t)
                    vs.append(v)
            vals = []
            for t in grid:
                we = t - off
                ws = we - w
                vals.append(self._window(func, ts, vs, ws, we))
            rows.append((dict(s.labels), vals))
        return _Vec(rows)

    # -- calls -----------------------------------------------------------
    def _call(self, node: pp.Call, grid: List[int]):
        name = node.name
        if name == "time":
            return [t / 1000.0 for t in grid]
        if name == "pi":
            return [math.pi] * len(grid)
        if name == "scalar":
            v = self._eval(node.args[0], grid)
            if not isinstance(v, _Vec):
                return v
            out = []
            for i in range(len(grid)):
                present = [row[i] for _, row in v.rows
                           if not _isnan(row[i])]
                if len(v.rows) == 1:
                    out.append(v.rows[0][1][i])
                elif len(present) == 1:
                    out.append(present[0])
                else:
                    out.append(NAN)
            return out
        if name == "vector":
            s = self._eval(node.args[0], grid)
            return _Vec([({}, list(s))])
        if name in pp.RANGE_FN_NAMES:
            return self._range_call(node, grid)
        if name == "histogram_quantile":
            return self._histogram_quantile(node, grid)
        if name in pp.INSTANT_FNS:
            return self._instant_call(node, grid)
        raise RefEvalError(f"function {name} outside refeval scope")

    def _histogram_quantile(self, node: pp.Call, grid: List[int]) -> _Vec:
        """Classic per-bucket series: join series sharing all labels
        except `le` into one cumulative histogram per step (the
        engine's _quantile_over_le_series — stale bucket samples
        dropped per step, +Inf bucket required, running-max
        monotonicity, Prometheus bucket interpolation)."""
        q_steps = self._eval(node.args[0], grid)
        if isinstance(q_steps, (_Vec, str)):
            raise RefEvalError("histogram_quantile non-scalar q")
        q = q_steps[0]
        v = self._eval(node.args[1], grid)
        if not isinstance(v, _Vec):
            raise RefEvalError("histogram_quantile over a scalar")
        groups: Dict[Tuple, List[Tuple[float, List[float]]]] = {}
        order: List[Tuple] = []
        for labels, row in v.rows:
            le_s = labels.get("le")
            if le_s is None:
                continue        # non-bucket series ignored (engine too)
            try:
                le = float(str(le_s).replace("+Inf", "inf"))
            except ValueError:
                continue
            base = tuple(sorted((k, val) for k, val
                                in _strip_metric(labels).items()
                                if k != "le"))
            if base not in groups:
                groups[base] = []
                order.append(base)
            groups[base].append((le, row))
        if not groups:
            raise RefEvalError("histogram_quantile requires per-bucket "
                               "series with an 'le' label")
        rows = []
        for base in order:
            members = sorted(groups[base], key=lambda m: m[0])
            les = [m[0] for m in members]
            vals = []
            for i in range(len(grid)):
                col = [(le, r[i]) for le, r in members
                       if not _isnan(r[i])]
                if not col:
                    vals.append(NAN)
                    continue
                lc = [le for le, _x in col]
                if not math.isinf(lc[-1]) or lc[-1] < 0:
                    vals.append(NAN)    # no +Inf sample: NaN
                    continue
                # running max down the buckets (ensureMonotonic)
                cum, run = [], -INF
                for _le, x in col:
                    run = max(run, x)
                    cum.append(run)
                vals.append(_bucket_quantile(q, lc, cum))
            rows.append((dict(base), vals))
        return _Vec(rows)

    def _range_call(self, node: pp.Call, grid: List[int]) -> _Vec:
        name = node.name
        func = pp.RANGE_FN_NAMES[name]
        args = list(node.args)
        if name in pp.RANGE_FN_SCALAR_FIRST:
            args.pop(0)
        if name in pp.RANGE_FN_SCALAR_AFTER:
            args = args[:1]
        rv = args[0]
        if isinstance(rv, pp.Selector):
            return self._range_series(rv, grid, func)
        if isinstance(rv, pp.Subquery):
            return self._subquery(rv, grid, func)
        raise RefEvalError(f"{name} over non-range argument")

    def _subquery(self, sq: pp.Subquery, grid: List[int], func: str
                  ) -> _Vec:
        """func(expr[w:s]): evaluate the inner on the subquery grid,
        then window over the inner step series (the engine's
        _subquery path; inner NaN steps are dropped)."""
        w, off = sq.window_ms, sq.offset_ms
        sub_step = sq.step_ms if sq.step_ms else self.step_ms
        inner_start = grid[0] - w - off
        inner_end = grid[-1] - off if off else grid[-1]
        inner_grid = list(range(inner_start, inner_end + 1, sub_step))
        inner = self._eval(sq.expr, inner_grid)
        if not isinstance(inner, _Vec):
            raise RefEvalError("scalar subquery outside scope")
        rows = []
        for labels, row in inner.rows:
            ts = [t for t, v in zip(inner_grid, row) if not _isnan(v)]
            vs = [v for v in row if not _isnan(v)]
            vals = []
            for t in grid:
                we = t - off
                ws = we - w
                vals.append(self._window(func, ts, vs, ws, we))
            rows.append((dict(labels), vals))
        return _Vec(rows)

    def _instant_call(self, node: pp.Call, grid: List[int]) -> _Vec:
        name = node.name
        v = self._eval(node.args[0], grid)
        if not isinstance(v, _Vec):
            raise RefEvalError(f"{name} over a scalar outside scope")
        args = []
        for a in node.args[1:]:
            sv = self._eval(a, grid)
            if isinstance(sv, (_Vec, str)):
                raise RefEvalError(f"{name} non-scalar parameter")
            args.append(sv[0])
        return _Vec([(_strip_metric(labels),
                      [eval_instant_fn(name, x, args) for x in row])
                     for labels, row in v.rows])

    # -- aggregation -----------------------------------------------------
    def _agg(self, node: pp.Agg, grid: List[int]) -> _Vec:
        inner = self._eval(node.expr, grid)
        if not isinstance(inner, _Vec):
            raise RefEvalError("aggregation over a scalar")
        op = node.op
        if op in ("topk", "bottomk"):
            return self._topk(node, inner, grid, bottom=(op == "bottomk"))
        groups: Dict[Tuple, Tuple[Dict[str, str], List[List[float]]]] = {}
        order: List[Tuple] = []
        for labels, row in inner.rows:
            l2 = _strip_metric(labels)
            if node.by:
                gk = {l: l2[l] for l in node.by if l in l2}
            elif node.without:
                gk = {l: v for l, v in l2.items()
                      if l not in node.without}
            else:
                gk = {}
            k = _key(gk)
            if k not in groups:
                groups[k] = (gk, [])
                order.append(k)
            groups[k][1].append(row)
        rows = []
        for k in order:
            gk, members = groups[k]
            vals = []
            for i in range(len(grid)):
                xs = [row[i] for row in members if not _isnan(row[i])]
                vals.append(self._agg_step(op, xs))
            rows.append((gk, vals))
        return _Vec(rows)

    def _topk(self, node: pp.Agg, inner: _Vec, grid: List[int],
              bottom: bool) -> _Vec:
        """topk/bottomk: per step, keep the k best series per group;
        output is the union of selected series (FULL labels, like the
        engine's TopBottomK) with NaN at unselected steps."""
        if not node.params:
            raise RefEvalError(f"{node.op} requires a k parameter")
        p = node.params[0]
        if not isinstance(p, pp.NumLit):
            raise RefEvalError(f"{node.op} non-literal k outside scope")
        k = int(p.value)
        # group like the engine (stripped labels), keep member rows
        groups: Dict[Tuple, List[int]] = {}
        order: List[Tuple] = []
        for i, (labels, _row) in enumerate(inner.rows):
            l2 = _strip_metric(labels)
            if node.by:
                gk = tuple(sorted((l, l2[l]) for l in node.by
                                  if l in l2))
            elif node.without:
                gk = tuple(sorted((l, v) for l, v in l2.items()
                                  if l not in node.without))
            else:
                gk = ()
            if gk not in groups:
                groups[gk] = []
                order.append(gk)
            groups[gk].append(i)
        rows = []
        for gk in order:
            idx = groups[gk]
            keep = {i: [False] * len(grid) for i in idx}
            for t in range(len(grid)):
                present = [(inner.rows[i][1][t], i) for i in idx
                           if not _isnan(inner.rows[i][1][t])]
                # stable per-step selection: best value first, input
                # order breaks ties (the engine's stable argsort)
                present.sort(key=lambda pv: pv[0],
                             reverse=not bottom)
                for _v, i in present[:k]:
                    keep[i][t] = True
            for i in idx:
                if any(keep[i]):
                    labels, row = inner.rows[i]
                    rows.append((dict(labels),
                                 [x if keep[i][t] else NAN
                                  for t, x in enumerate(row)]))
        return _Vec(rows)

    @staticmethod
    def _agg_step(op: str, xs: List[float]) -> float:
        if not xs:
            return NAN
        if op == "sum":
            return sum(xs)
        if op == "count":
            return float(len(xs))
        if op == "avg":
            return sum(xs) / len(xs)
        if op == "min":
            return min(xs)
        if op == "max":
            return max(xs)
        if op == "group":
            return 1.0
        if op == "stddev":
            return math.sqrt(_variance(xs))
        if op == "stdvar":
            return _variance(xs)
        raise RefEvalError(f"aggregation {op} outside refeval scope")

    # -- binary operators -------------------------------------------------
    def _binop(self, node: pp.BinOp, grid: List[int]):
        lhs = self._eval(node.lhs, grid)
        rhs = self._eval(node.rhs, grid)
        lvec = isinstance(lhs, _Vec)
        rvec = isinstance(rhs, _Vec)
        op = node.op
        if op in ("and", "or", "unless"):
            return self._set_op(op, lhs, rhs, node)
        if not lvec and not rvec:
            # scalar-scalar: the engine evaluates comparisons as bool
            rb = op in _COMP or node.return_bool
            return [self._op(op, a, b, rb)
                    for a, b in zip(lhs, rhs)]
        if lvec != rvec:
            vec, sc = (lhs, rhs) if lvec else (rhs, lhs)
            rows = []
            for labels, row in vec.rows:
                out = []
                for i, x in enumerate(row):
                    a, b = (sc[i], x) if not lvec else (x, sc[i])
                    out.append(self._op(op, a, b, node.return_bool,
                                         keep=x))
                rows.append((_strip_metric(labels), out))
            return _Vec(rows)
        return self._vector_join(node, lhs, rhs)

    def _join_key(self, labels: Mapping[str, str],
                  on: Optional[Tuple[str, ...]],
                  ignoring: Tuple[str, ...]) -> Tuple:
        l2 = _strip_metric(labels)
        if on is not None:
            return tuple(sorted((k, v) for k, v in l2.items()
                                if k in on))
        return tuple(sorted((k, v) for k, v in l2.items()
                            if k not in ignoring))

    def _vector_join(self, node: pp.BinOp, lhs: _Vec, rhs: _Vec) -> _Vec:
        if node.group_left or node.group_right:
            return self._grouped_join(node, lhs, rhs)
        rmap: Dict[Tuple, Tuple[Dict[str, str], List[float]]] = {}
        for labels, row in rhs.rows:
            k = self._join_key(labels, node.on, node.ignoring)
            if k in rmap:
                raise RefEvalError("many-to-many: duplicate right side")
            rmap[k] = (labels, row)
        rows = []
        seen = set()
        for labels, row in lhs.rows:
            k = self._join_key(labels, node.on, node.ignoring)
            got = rmap.get(k)
            if got is None:
                continue
            if k in seen:
                raise RefEvalError("many-to-many: duplicate left side")
            seen.add(k)
            out = [self._op(node.op, a, b, node.return_bool)
                   for a, b in zip(row, got[1])]
            rows.append((_strip_metric(labels), out))
        return _Vec(rows)

    def _grouped_join(self, node: pp.BinOp, lhs: _Vec, rhs: _Vec) -> _Vec:
        """Many-to-one / one-to-many join (the engine's BinaryJoinExec
        grouped path): operands keep their ORIGINAL sides, output
        labels come from the 'many' side, include labels are copied
        from the 'one' side (or dropped when absent there), and a
        duplicate series on the 'one' side is a many-to-many error."""
        many, one = (lhs, rhs) if node.group_left else (rhs, lhs)
        omap: Dict[Tuple, Tuple[Dict[str, str], List[float]]] = {}
        for labels, row in one.rows:
            k = self._join_key(labels, node.on, node.ignoring)
            if k in omap:
                raise RefEvalError(
                    "many-to-many join: duplicate series on 'one' side")
            omap[k] = (labels, row)
        rows = []
        for labels, row in many.rows:
            k = self._join_key(labels, node.on, node.ignoring)
            got = omap.get(k)
            if got is None:
                continue
            if node.group_left:
                a_row, b_row = row, got[1]
            else:
                a_row, b_row = got[1], row
            out = [self._op(node.op, a, b, node.return_bool)
                   for a, b in zip(a_row, b_row)]
            l2 = dict(_strip_metric(labels))
            for l in node.include:
                if l in got[0]:
                    l2[l] = got[0][l]
                else:
                    l2.pop(l, None)
            rows.append((l2, out))
        return _Vec(rows)

    def _set_op(self, op: str, lhs, rhs, node: pp.BinOp) -> _Vec:
        if not isinstance(lhs, _Vec) or not isinstance(rhs, _Vec):
            raise RefEvalError("set op on scalar operand")
        rkeys = {self._join_key(l, node.on, node.ignoring): row
                 for l, row in rhs.rows}
        rows = []
        if op == "and":
            for labels, row in lhs.rows:
                rrow = rkeys.get(self._join_key(labels, node.on,
                                                node.ignoring))
                if rrow is None:
                    continue
                rows.append((dict(labels),
                             [v if not _isnan(r) else NAN
                              for v, r in zip(row, rrow)]))
        elif op == "unless":
            for labels, row in lhs.rows:
                rrow = rkeys.get(self._join_key(labels, node.on,
                                                node.ignoring))
                if rrow is None:
                    rows.append((dict(labels), list(row)))
                else:
                    rows.append((dict(labels),
                                 [v if _isnan(r) else NAN
                                  for v, r in zip(row, rrow)]))
        else:   # or
            lkeys = set()
            for labels, row in lhs.rows:
                lkeys.add(self._join_key(labels, node.on, node.ignoring))
                rows.append((dict(labels), list(row)))
            for labels, row in rhs.rows:
                if self._join_key(labels, node.on,
                                  node.ignoring) not in lkeys:
                    rows.append((dict(labels), list(row)))
        return _Vec(rows)


def ref_eval(query: str, series: Sequence[RefSeries], start_s: int,
             step_s: int, end_s: int,
             lookback_ms: int = DEFAULT_LOOKBACK_MS,
             extrapolate: Callable = _extrapolated,
             arith: Mapping[str, Callable] = _ARITH
             ) -> Dict[Tuple, List[float]]:
    """Evaluate ``query`` over ``series`` on the [start, step, end]
    second grid; returns {sorted-label-items tuple: per-step values}.
    ``extrapolate`` (the rate family's window) and ``arith`` (the
    arithmetic operators) default to the Prometheus semantics."""
    ast = pp.Parser(query).parse()
    ev = RefEvaluator(series, start_s, step_s, end_s, lookback_ms,
                      extrapolate, arith)
    vec = ev.eval(ast)
    out: Dict[Tuple, List[float]] = {}
    for labels, row in vec.rows:
        k = _key(labels)
        if k in out:
            raise RefEvalError(f"duplicate output series {k}")
        out[k] = row
    return out
