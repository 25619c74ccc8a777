"""LogicalPlan → PromQL string round-trip (the counterpart of
``filodb_tpu.query.planparser``).

(coordinator/queryplanner/LogicalPlanParser.scala — the reference prints
plans back to PromQL so whole queries can be forwarded to remote clusters
via PromQlRemoteExec.) Returns None for shapes with no faithful PromQL
rendering; callers fall back to leaf dispatch.
"""

from __future__ import annotations

from typing import Optional

import re

from filodb_tpu_torch.query import logical as lp

_METRIC_LABELS = ("_metric_", "__name__")
_IDENT = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*$")


def _num(x) -> str:
    """Full-precision numeric literal (repr round-trips f64 exactly;
    %g's 6 digits would silently shift @ instants / thresholds)."""
    f = float(x)
    return str(int(f)) if f.is_integer() else repr(f)


def _dur(ms: int) -> str:
    if ms % 3_600_000 == 0:
        return f"{ms // 3_600_000}h"
    if ms % 60_000 == 0:
        return f"{ms // 60_000}m"
    if ms % 1000 == 0:
        return f"{ms // 1000}s"
    return f"{ms}ms"


_OPS = {"eq": "=", "neq": "!=", "re": "=~", "nre": "!~"}


def _q(s: str) -> str:
    """Quote a PromQL string literal (escape backslashes + quotes so the
    peer's parser reads back the identical value)."""
    return '"' + s.replace("\\", "\\\\").replace('"', '\\"') + '"'


def _selector(raw: lp.RawSeriesPlan, window_ms: Optional[int],
              offset_ms: int, at_ms: Optional[int]) -> Optional[str]:
    metric = ""
    matchers = []
    for f in raw.filters:
        if f.label in _METRIC_LABELS and f.op == "eq" and not metric \
                and _IDENT.match(f.value):
            metric = f.value
            continue
        op = _OPS.get(f.op)
        if op is None:
            return None     # in/prefix filters have no PromQL spelling
        matchers.append(f"{f.label}{op}{_q(f.value)}")
    s = metric
    if matchers or not metric:
        s += "{" + ",".join(matchers) + "}"
    if raw.column:
        s += f"::{raw.column}"
    if window_ms is not None:
        s += f"[{_dur(window_ms)}]"
    if offset_ms:
        s += f" offset {_dur(offset_ms)}"
    if at_ms is not None:
        s += f" @ {_num(at_ms / 1000)}"
    return s


def plan_to_promql(plan) -> Optional[str]:
    """PromQL text for a plan, or None when not expressible (never
    raises — unprintable shapes fall back to leaf dispatch)."""
    try:
        return _print(plan)
    except (TypeError, ValueError):
        return None


def _print(plan) -> Optional[str]:
    if isinstance(plan, lp.PeriodicSeries):
        return _selector(plan.raw, None, plan.offset_ms, plan.at_ms)
    if isinstance(plan, lp.PeriodicSeriesWithWindowing):
        inner = _selector(plan.raw, plan.window_ms, plan.offset_ms,
                          plan.at_ms)
        if inner is None:
            return None
        # predict_linear/holt_winters take their scalars AFTER the range
        # vector (the parser's RANGE_FN_SCALAR_AFTER table); the rest
        # (quantile_over_time) take them before
        from filodb_tpu_torch.promql.parser import RANGE_FN_SCALAR_AFTER
        if plan.function in RANGE_FN_SCALAR_AFTER:
            args = "".join(f", {_num(a)}" for a in plan.func_args)
            return f"{plan.function}({inner}{args})"
        args = "".join(f"{_num(a)}, " for a in plan.func_args)
        return f"{plan.function}({args}{inner})"
    if isinstance(plan, lp.Aggregate):
        inner = _print(plan.inner)
        if inner is None:
            return None
        mod = ""
        if plan.by:
            mod = f" by ({', '.join(plan.by)})"
        elif plan.without:
            mod = f" without ({', '.join(plan.without)})"
        params = "".join(
            (f"{_q(p)}, " if isinstance(p, str) else f"{_num(p)}, ")
            for p in plan.params)
        return f"{plan.op}({params}{inner}){mod}"
    if isinstance(plan, lp.BinaryJoin):
        lhs = _print(plan.lhs)
        rhs = _print(plan.rhs)
        if lhs is None or rhs is None:
            return None
        op = plan.op + (" bool" if plan.return_bool else "")
        mod = ""
        if plan.on is not None:
            mod = f" on ({', '.join(plan.on)})"
        elif plan.ignoring:
            mod = f" ignoring ({', '.join(plan.ignoring)})"
        # always parenthesize the include list: a bare group_left followed
        # by the parenthesized rhs would parse the parens as labels
        if plan.cardinality == "many-to-one":
            mod += f" group_left({', '.join(plan.include)})"
        elif plan.cardinality == "one-to-many":
            mod += f" group_right({', '.join(plan.include)})"
        return f"({lhs}) {op}{mod} ({rhs})"
    if isinstance(plan, lp.ScalarVectorBinaryOperation):
        sc = _print(plan.scalar)
        vec = _print(plan.vector)
        if sc is None or vec is None:
            return None
        op = plan.op + (" bool" if plan.return_bool else "")
        return f"({sc}) {op} ({vec})" if plan.scalar_is_lhs \
            else f"({vec}) {op} ({sc})"
    if isinstance(plan, lp.ApplyInstantFunction):
        inner = _print(plan.inner)
        if inner is None:
            return None
        args = []
        for a in plan.func_args:
            s = _print(a) if not isinstance(a, (int, float)) \
                else _num(a)
            if s is None:
                return None
            args.append(s)
        # the parser puts scalars BEFORE the vector only for the
        # histogram_quantile family; clamp/round take them after
        from filodb_tpu_torch.promql.parser import INSTANT_FN_SCALAR_FIRST
        if plan.function in INSTANT_FN_SCALAR_FIRST:
            joined = "".join(f"{a}, " for a in args)
            return f"{plan.function}({joined}{inner})"
        joined = "".join(f", {a}" for a in args)
        return f"{plan.function}({inner}{joined})"
    if isinstance(plan, lp.ApplyMiscellaneousFunction):
        inner = _print(plan.inner)
        if inner is None:
            return None
        args = "".join(f", {_q(a)}" for a in plan.str_args)
        return f"{plan.function}({inner}{args})"
    if isinstance(plan, lp.ApplySortFunction):
        inner = _print(plan.inner)
        return None if inner is None else \
            (f"sort_desc({inner})" if plan.descending else f"sort({inner})")
    if isinstance(plan, lp.ScalarFixedDoublePlan):
        return _num(plan.value)
    if isinstance(plan, lp.ScalarTimeBasedPlan):
        return f"{plan.function}()"
    if isinstance(plan, lp.ScalarVaryingDoublePlan):
        inner = _print(plan.inner)
        return None if inner is None else f"scalar({inner})"
    if isinstance(plan, lp.VectorPlan):
        inner = _print(plan.scalar)
        return None if inner is None else f"vector({inner})"
    return None
