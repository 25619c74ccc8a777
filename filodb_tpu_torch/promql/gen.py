"""Property-based PromQL generator — well-typed by construction.

Generates random queries THROUGH the promlint type rules
(:mod:`filodb_tpu_torch.promql.semant`): every production site knows the type
it must produce (instant vector / range vector / scalar), counter
metrics feed the rate family and gauges feed the gauge family, binary
joins are built so the match is provably one-to-one, and every emitted
query is double-checked against the analyzer (zero error-severity
findings) and the parser's plan builder before it leaves this module —
a generator bug fails loudly here, not as a mystery discrepancy
downstream.

Determinism: seeded ``random.Random``; the same ``(seed, metrics)``
yields the same query list on every run, so the differential soak
(tests/test_torch_promql_differential.py) is reproducible and a discrepancy
can be pinned by (seed, index) alone.

The function surface deliberately matches what
:mod:`filodb_tpu_torch.promql.refeval` implements — growing one without the
other trips the generator's self-check or the soak immediately.
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from filodb_tpu_torch.promql import semant
from filodb_tpu_torch.promql.parser import (Parser, TimeStepParams,
                                      parse_query_range)


@dataclass(frozen=True)
class MetricSpec:
    """One generatable metric: name, schema kind, label universe."""
    name: str
    kind: str                                   # "counter" | "gauge"
    labels: Tuple[Tuple[str, Tuple[str, ...]], ...] = ()

    def label_names(self) -> List[str]:
        return [l for l, _vals in self.labels]


DEFAULT_METRICS: Tuple[MetricSpec, ...] = (
    MetricSpec("http_requests_total", "counter",
               (("job", ("api", "web")),
                ("instance", ("i0", "i1", "i2")))),
    MetricSpec("errors_total", "counter",
               (("job", ("api", "web")),
                ("instance", ("i0", "i1", "i2")))),
    MetricSpec("cpu_usage", "gauge",
               (("job", ("api", "web")),
                ("instance", ("i0", "i1", "i2")))),
    MetricSpec("queue_depth", "gauge",
               (("job", ("api",)),
                ("instance", ("i0", "i1", "i2")))),
)

# classic-bucket histogram metric: generated histogram_quantile shapes
# select it WITHOUT an `le` matcher so every bucket set stays complete
DEFAULT_HISTOGRAM = MetricSpec(
    "http_request_duration_seconds_bucket", "counter",
    (("job", ("api", "web")), ("instance", ("i0", "i1"))))
_HIST_QS = ("0.5", "0.9", "0.95", "0.99")

_COUNTER_FNS = ("rate", "increase", "irate", "resets", "changes")
_GAUGE_FNS = ("delta", "idelta", "deriv", "avg_over_time",
              "min_over_time", "max_over_time", "sum_over_time",
              "stddev_over_time", "stdvar_over_time", "changes")
_ANY_OVER_TIME = ("last_over_time", "first_over_time",
                  "count_over_time", "present_over_time")
_AGG_OPS = ("sum", "avg", "min", "max", "count", "group",
            "stddev", "stdvar")
_INSTANT_FNS = ("abs", "ceil", "floor", "sqrt", "sgn", "round",
                "clamp_min", "clamp_max", "clamp")
_ARITH_OPS = ("+", "-", "*", "/", "%", "^")
_CMP_OPS = ("==", "!=", ">", "<", ">=", "<=")
_SET_OPS = ("and", "or", "unless")
_WINDOWS = ("1m", "90s", "2m", "5m")
_SUB_WINDOWS = ("4m", "6m", "10m")
_SUB_STEPS = ("30s", "1m")
_OFFSETS = ("1m", "2m")
_SUBQ_FNS = ("avg_over_time", "max_over_time", "min_over_time",
             "sum_over_time", "last_over_time", "count_over_time")


class QueryGen:
    """Seeded well-typed query generator over a metric universe."""

    _HIST_DEFAULT = object()    # sentinel: follow the metric universe

    def __init__(self, seed: int = 0,
                 metrics: Sequence[MetricSpec] = DEFAULT_METRICS,
                 max_depth: int = 3, validate: bool = True,
                 histogram=_HIST_DEFAULT):
        self.rng = random.Random(seed)
        self.metrics = list(metrics)
        # the default bucket metric rides only the DEFAULT universe; a
        # custom universe opts in by passing histogram= explicitly
        if histogram is QueryGen._HIST_DEFAULT:
            histogram = DEFAULT_HISTOGRAM \
                if tuple(metrics) == DEFAULT_METRICS else None
        self.histogram: Optional[MetricSpec] = histogram
        self.max_depth = max_depth
        self.validate = validate
        known = {m.name: m.kind for m in self.metrics}
        if histogram is not None:
            known[histogram.name] = histogram.kind
        self.schemas = semant.MetricSchemas(known)
        # the validation range only needs to typecheck plan building
        self._params = TimeStepParams(1_600_000_000, 30, 1_600_000_600)

    # -- helpers ---------------------------------------------------------
    def _pick(self, xs):
        return xs[self.rng.randrange(len(xs))]

    def _metric(self, kind: Optional[str] = None) -> MetricSpec:
        pool = [m for m in self.metrics
                if kind is None or m.kind == kind]
        # a single-kind universe still generates: fall back to any
        # metric (the production sites re-check the actual kind)
        return self._pick(pool or self.metrics)

    def _scalar_lit(self) -> str:
        return self._pick(("0.5", "1", "2", "5", "10", "0.25", "100"))

    def _selector(self, m: MetricSpec, window: Optional[str] = None
                  ) -> str:
        parts = []
        for label, vals in m.labels:
            r = self.rng.random()
            if r < 0.25:
                parts.append(f'{label}="{self._pick(vals)}"')
            elif r < 0.35 and len(vals) > 1:
                alt = "|".join(
                    sorted(self.rng.sample(list(vals),
                                           self.rng.randrange(
                                               2, len(vals) + 1))))
                parts.append(f'{label}=~"{alt}"')
            elif r < 0.42:
                parts.append(f'{label}!="{self._pick(vals)}"')
        sel = m.name + ("{" + ",".join(parts) + "}" if parts else "")
        if window:
            sel += f"[{window}]"
        if self.rng.random() < 0.15:
            sel += f" offset {self._pick(_OFFSETS)}"
        return sel

    # -- productions -----------------------------------------------------
    def _range_fn_expr(self, depth: int) -> str:
        """range_fn(selector[w]) or fn(<instant expr>[w:s])."""
        if depth > 0 and self.rng.random() < 0.2:
            inner = self._vector(depth - 1, allow_binop=False)
            w = self._pick(_SUB_WINDOWS)
            s = self._pick(_SUB_STEPS) if self.rng.random() < 0.8 else ""
            return f"{self._pick(_SUBQ_FNS)}({inner}[{w}:{s}])"
        m = self._metric()
        if m.kind == "counter":
            fn = self._pick(_COUNTER_FNS + _ANY_OVER_TIME)
        else:
            fn = self._pick(_GAUGE_FNS + _ANY_OVER_TIME)
        return f"{fn}({self._selector(m, self._pick(_WINDOWS))})"

    def _agg_expr(self, depth: int) -> str:
        inner = self._vector(depth - 1)
        op = self._pick(_AGG_OPS)
        m_labels = sorted({l for m in self.metrics
                           for l in m.label_names()})
        r = self.rng.random()
        if r < 0.45:
            k = self.rng.randrange(1, len(m_labels) + 1)
            by = ",".join(sorted(self.rng.sample(m_labels, k)))
            return f"{op} by ({by}) ({inner})"
        if r < 0.65:
            drop = self._pick(m_labels)
            return f"{op} without ({drop}) ({inner})"
        return f"{op}({inner})"

    def _binop_expr(self, depth: int) -> str:
        r = self.rng.random()
        if r < 0.45:
            # vector <op> scalar (either side)
            v = self._vector(depth - 1, allow_binop=False)
            s = self._scalar_lit()
            if self.rng.random() < 0.6:
                op = self._pick(_ARITH_OPS)
                return f"({v} {op} {s})" if self.rng.random() < 0.7 \
                    else f"({s} {op} {v})"
            op = self._pick(_CMP_OPS)
            b = "bool " if self.rng.random() < 0.4 else ""
            return f"({v} {op} {b}{s})" if self.rng.random() < 0.7 \
                else f"({s} {op} {b}{v})"
        if r < 0.8:
            # same-metric two-sided op: both sides select the SAME
            # series set, so the full-label-set match is one-to-one
            m = self._metric()
            sel = self._selector(m)
            if m.kind == "counter":
                lhs = f"{self._pick(_COUNTER_FNS)}({sel}[{self._pick(_WINDOWS)}])"
                rhs = f"{self._pick(_COUNTER_FNS)}({sel}[{self._pick(_WINDOWS)}])"
            else:
                lhs = sel
                rhs = f"avg_over_time({sel}[{self._pick(_WINDOWS)}])"
            if self.rng.random() < 0.3:
                op = self._pick(_CMP_OPS)
                b = "bool " if self.rng.random() < 0.5 else ""
                return f"({lhs} {op} {b}{rhs})"
            op = self._pick(_ARITH_OPS)
            return f"({lhs} {op} {rhs})"
        if r < 0.92:
            # closed-set join: agg by (L) on both sides, matched on(L)
            labels = ("job",) if self.rng.random() < 0.5 \
                else ("instance",)
            ls = ",".join(labels)
            lhs = f"sum by ({ls}) ({self._vector(depth - 1, allow_binop=False)})"
            rhs = f"sum by ({ls}) ({self._vector(depth - 1, allow_binop=False)})"
            op = self._pick(_ARITH_OPS)
            on = f" on ({ls}) " if self.rng.random() < 0.6 else " "
            return f"({lhs} {op}{on}{rhs})"
        # set op between selectors of the same metric
        m = self._metric()
        op = self._pick(_SET_OPS)
        return (f"({self._selector(m)} {op} "
                f"{self._selector(m)})")

    def _histogram_expr(self, depth: int) -> str:
        """histogram_quantile over the classic-bucket metric: the
        float-compare + bucket-interpolation shape. The inner is
        rate()/increase() on the bucket counters, optionally re-summed
        by (le, ...) — `le` always survives so every group keeps a
        complete cumulative histogram."""
        m = self.histogram
        q = self._pick(_HIST_QS)
        w = self._pick(_WINDOWS)
        fn = self._pick(("rate", "increase"))
        inner = f"{fn}({self._selector(m, w)})"
        if self.rng.random() < 0.5:
            keep = self._pick(("le", "le,job", "le,instance"))
            inner = f"sum by ({keep}) ({inner})"
        return f"histogram_quantile({q}, {inner})"

    def _topk_expr(self, depth: int) -> str:
        """topk/bottomk over a CONTINUOUS-valued inner (rate/deriv/
        avg_over_time): partial-sort determinism is only well-defined
        engine-vs-reference when per-step ties have measure zero, so
        discrete-valued inners (counts, present) stay out."""
        op = self._pick(("topk", "bottomk"))
        k = self._pick(("1", "2", "3"))
        m = self._metric()
        w = self._pick(_WINDOWS)
        if m.kind == "counter":
            inner = f"{self._pick(('rate', 'increase'))}({self._selector(m, w)})"
        else:
            inner = f"{self._pick(('avg_over_time', 'deriv'))}({self._selector(m, w)})"
        return f"{op}({k}, {inner})"

    def _grouped_join_expr(self, depth: int) -> str:
        """many-to-one join: the 'many' side keeps full series labels,
        the 'one' side is aggregated to exactly the match key, so the
        join is provably many-to-one (semant's group_* rules pass by
        construction)."""
        labels = ("job",) if self.rng.random() < 0.5 else ("instance",)
        ls = ",".join(labels)
        m = self._metric("counter")
        w = self._pick(_WINDOWS)
        many = f"{self._pick(('rate', 'increase'))}({self._selector(m, w)})"
        one_m = self._metric("counter")
        one = (f"sum by ({ls}) "
               f"({self._pick(('rate', 'increase'))}"
               f"({self._selector(one_m, self._pick(_WINDOWS))}))")
        op = self._pick(("/", "*", "+", "-"))
        if self.rng.random() < 0.5:
            return f"({many} {op} on ({ls}) group_left {one})"
        return f"({one} {op} on ({ls}) group_right {many})"

    def _instant_fn_expr(self, depth: int) -> str:
        fn = self._pick(_INSTANT_FNS)
        inner = self._vector(depth - 1)
        if fn == "clamp":
            lo = self._pick(("0", "1"))
            hi = self._pick(("10", "100"))
            return f"clamp({inner}, {lo}, {hi})"
        if fn in ("clamp_min", "clamp_max"):
            return f"{fn}({inner}, {self._scalar_lit()})"
        if fn == "round" and self.rng.random() < 0.5:
            return f"round({inner}, {self._pick(('0.5', '2', '10'))})"
        return f"{fn}({inner})"

    def _vector(self, depth: int, allow_binop: bool = True) -> str:
        if depth <= 0:
            if self.rng.random() < 0.5:
                return self._selector(self._metric("gauge"))
            return self._range_fn_expr(0)
        r = self.rng.random()
        if r < 0.27:
            return self._range_fn_expr(depth)
        if r < 0.48:
            return self._agg_expr(depth)
        if r < 0.66 and allow_binop:
            return self._binop_expr(depth)
        if r < 0.78:
            return self._instant_fn_expr(depth)
        if r < 0.84 and self.histogram is not None:
            return self._histogram_expr(depth)
        if r < 0.9:
            return self._topk_expr(depth)
        if r < 0.95 and allow_binop:
            return self._grouped_join_expr(depth)
        return self._selector(self._metric("gauge"))

    # -- public ----------------------------------------------------------
    def query(self) -> str:
        """One well-typed query (validated: parses, plan-builds, and
        promlint-clean of error-severity findings)."""
        for _attempt in range(64):
            q = self._vector(self.rng.randrange(1, self.max_depth + 1))
            if not self.validate:
                return q
            diags = semant.lint_query(q, self.schemas)
            if semant.errors(diags):
                continue
            try:
                parse_query_range(q, self._params)
            except Exception:   # noqa: BLE001 — regenerate on any reject
                continue
            return q
        raise AssertionError(
            "QueryGen could not produce a valid query in 64 attempts — "
            "generator and type checker have drifted apart")

    def queries(self, n: int) -> List[str]:
        return [self.query() for _ in range(n)]
