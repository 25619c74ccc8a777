"""PromQL parser: query text -> LogicalPlan.

Hand-written recursive-descent parser with the same surface as the reference's
ANTLR grammar (prometheus/src/main/java/filodb/prometheus/antlr/PromQL.g4;
AST -> LogicalPlan conversion in prometheus/src/main/scala/filodb/prometheus/
ast/Vectors.scala, Functions.scala, Aggregates.scala, Expressions.scala).

Supported: literals, vector selectors with matchers, range + subquery
selectors, offset, all range/instant/aggregation functions in the engine
registry, binary operators with Prometheus precedence/associativity, bool
modifier, on/ignoring + group_left/group_right vector matching, by/without
grouping (both positions), scalar()/vector()/time()/absent().
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple, Union

from filodb_tpu_torch.core.index import ColumnFilter
from filodb_tpu_torch.query import logical as lp
from filodb_tpu_torch.query.rangefn import RANGE_FUNCTIONS

DEFAULT_LOOKBACK_MS = 300_000   # Prometheus default staleness period

METRIC_COLUMN = "_metric_"

# ---------------------------------------------------------------------------
# Lexer
# ---------------------------------------------------------------------------

_TOKEN_RE = re.compile(r"""
    (?P<WS>\s+|\#[^\n]*)
  | (?P<DURATION>[0-9]+(?:\.[0-9]+)?(?:ms|s|m|h|d|w|y)(?:[0-9]+(?:\.[0-9]+)?(?:ms|s|m|h|d|w|y))*)
  | (?P<NUMBER>
        0x[0-9a-fA-F]+
      | (?:[0-9]+\.?[0-9]*|\.[0-9]+)(?:[eE][+-]?[0-9]+)?
      | [iI][nN][fF]
      | [nN][aA][nN])
  | (?P<IDENT>[a-zA-Z_][a-zA-Z0-9_:.]*)
  | (?P<STRING>"(?:\\.|[^"\\])*"|'(?:\\.|[^'\\])*'|`[^`]*`)
  | (?P<OP>=~|!~|==|!=|<=|>=|[-+*/%^(){}\[\],=<>@:])
""", re.VERBOSE)

_DUR_UNIT_MS = {"ms": 1, "s": 1000, "m": 60_000, "h": 3_600_000,
                "d": 86_400_000, "w": 7 * 86_400_000, "y": 365 * 86_400_000}
_DUR_PART_RE = re.compile(r"([0-9]+(?:\.[0-9]+)?)(ms|s|m|h|d|w|y)")


def parse_duration_ms(text: str) -> int:
    """Duration string -> milliseconds. Rejects empty/malformed text —
    every part must parse, and the parts must cover the whole string
    (``5mm``, ``5``, ``m5`` and "" all raise ValueError)."""
    total = 0.0
    covered = 0
    for m in _DUR_PART_RE.finditer(text):
        if m.start() != covered:
            break
        total += float(m.group(1)) * _DUR_UNIT_MS[m.group(2)]
        covered = m.end()
    if covered != len(text) or not text:
        raise ValueError(f"invalid duration {text!r}")
    return int(total)


@dataclass
class Token:
    kind: str
    text: str
    pos: int

    @property
    def end(self) -> int:
        return self.pos + len(self.text)


class ParseError(ValueError):
    """Syntax/semantic rejection at parse time. ``pos``/``end`` are
    character offsets into the query text (-1 = unknown) so callers can
    render a caret span (promlint diagnostics reuse these spans)."""

    def __init__(self, message: str, pos: int = -1, end: int = -1):
        super().__init__(message)
        self.pos = int(pos)
        self.end = int(end) if end >= 0 else \
            (int(pos) + 1 if pos >= 0 else -1)


def tokenize(q: str) -> List[Token]:
    out: List[Token] = []
    pos = 0
    while pos < len(q):
        m = _TOKEN_RE.match(q, pos)
        if not m:
            raise ParseError(f"unexpected character {q[pos]!r} at {pos}",
                             pos=pos)
        kind = m.lastgroup
        if kind != "WS":
            out.append(Token(kind, m.group(), pos))
        pos = m.end()
    return out


# ---------------------------------------------------------------------------
# AST
# ---------------------------------------------------------------------------

@dataclass
class Matcher:
    label: str
    op: str     # = != =~ !~
    value: str


@dataclass
class Selector:
    metric: Optional[str]
    matchers: List[Matcher]
    window_ms: Optional[int] = None
    offset_ms: int = 0
    # int ms, or "start"/"end" (@ start()/@ end()), resolved against the
    # query range at plan conversion
    at_ms: object = None
    column: Optional[str] = None   # FiloDB ::column suffix
    pos: int = -1                  # char span in the query text
    end: int = -1


@dataclass
class NumLit:
    value: float
    pos: int = -1
    end: int = -1


@dataclass
class StrLit:
    value: str
    pos: int = -1
    end: int = -1


@dataclass
class Call:
    name: str
    args: List
    pos: int = -1
    end: int = -1


@dataclass
class Agg:
    op: str
    expr: object
    params: List
    by: Tuple[str, ...] = ()
    without: Tuple[str, ...] = ()
    pos: int = -1
    end: int = -1


@dataclass
class BinOp:
    op: str
    lhs: object
    rhs: object
    return_bool: bool = False
    on: Optional[Tuple[str, ...]] = None
    ignoring: Tuple[str, ...] = ()
    group_left: bool = False
    group_right: bool = False
    include: Tuple[str, ...] = ()
    pos: int = -1                  # span of the operator token
    end: int = -1


@dataclass
class Subquery:
    expr: object
    window_ms: int
    step_ms: Optional[int]
    offset_ms: int = 0
    # int ms, or "start"/"end" (@ start()/@ end()), resolved against the
    # query range at plan conversion
    at_ms: object = None
    pos: int = -1
    end: int = -1


@dataclass
class Unary:
    op: str
    expr: object
    pos: int = -1
    end: int = -1


def ast_span(node) -> Tuple[int, int]:
    """(pos, end) char span of any AST node (-1, -1 when unknown)."""
    return (getattr(node, "pos", -1), getattr(node, "end", -1))


AGG_OPS = {"sum", "avg", "min", "max", "count", "stddev", "stdvar", "group",
           "topk", "bottomk", "quantile", "count_values", "absent_hack"}

# aggregations taking a leading parameter
AGG_PARAM_OPS = {"topk", "bottomk", "quantile", "count_values", "limitk"}

# PromQL surface name -> engine range function name (identity for most)
RANGE_FN_NAMES = {name: name for name in RANGE_FUNCTIONS} | {
    "zscore": "z_score",
    "median_absolute_deviation_over_time": "mad_over_time",
}
# functions with (scalar, range-vector) argument order
RANGE_FN_SCALAR_FIRST = {"quantile_over_time"}
# functions with (range-vector, scalar...) order
RANGE_FN_SCALAR_AFTER = {"predict_linear", "holt_winters"}
# instant functions with (scalar, vector) order; all others take the
# vector first (shared with the plan printer — planparser.py)
INSTANT_FN_SCALAR_FIRST = ("histogram_quantile", "histogram_bucket",
                           "histogram_max_quantile")

INSTANT_FNS = {
    "abs", "ceil", "floor", "exp", "ln", "log2", "log10", "sqrt", "round",
    "sgn", "clamp", "clamp_min", "clamp_max", "histogram_quantile",
    "histogram_bucket", "histogram_max_quantile", "acos", "asin", "atan",
    "cos", "cosh", "sin", "sinh", "tan", "tanh", "deg", "rad",
    "days_in_month", "day_of_month", "day_of_week", "day_of_year", "hour",
    "minute", "month", "year",
}

MISC_FNS = {"label_replace", "label_join"}

_CMP_OPS = {"==", "!=", ">", "<", ">=", "<="}

# precedence (higher binds tighter); ^ is right-associative
_PRECEDENCE = [
    ({"or"}, "left"),
    ({"and", "unless"}, "left"),
    (_CMP_OPS, "left"),
    ({"+", "-"}, "left"),
    ({"*", "/", "%", "atan2"}, "left"),
    ({"^"}, "right"),
]


class Parser:
    def __init__(self, query: str):
        self.toks = tokenize(query)
        self.i = 0

    # -- token helpers ---------------------------------------------------
    def peek(self, ahead: int = 0) -> Optional[Token]:
        j = self.i + ahead
        return self.toks[j] if j < len(self.toks) else None

    def next(self) -> Token:
        t = self.peek()
        if t is None:
            raise ParseError("unexpected end of query", pos=self._eof_pos())
        self.i += 1
        return t

    def accept(self, text: str) -> bool:
        t = self.peek()
        if t is not None and t.text == text:
            self.i += 1
            return True
        return False

    def expect(self, text: str) -> Token:
        t = self.peek()
        if t is None or t.text != text:
            got = t.text if t else "<eof>"
            raise ParseError(f"expected {text!r}, got {got!r}",
                             pos=t.pos if t else self._eof_pos(),
                             end=t.end if t else -1)
        return self.next()

    def at_end(self) -> bool:
        return self.i >= len(self.toks)

    def _eof_pos(self) -> int:
        return self.toks[-1].end if self.toks else 0

    def _last_end(self) -> int:
        return self.toks[self.i - 1].end if self.i else 0

    # -- grammar ---------------------------------------------------------
    def parse(self):
        e = self.parse_expr(0)
        if not self.at_end():
            t = self.peek()
            raise ParseError(f"trailing input at {t.text!r}",
                             pos=t.pos, end=t.end)
        return e

    def parse_expr(self, level: int):
        if level >= len(_PRECEDENCE):
            return self.parse_unary()
        ops, assoc = _PRECEDENCE[level]
        lhs = self.parse_expr(level + 1)
        while True:
            t = self.peek()
            if t is None or t.text not in ops:
                break
            op_tok = self.next()
            op = op_tok.text
            return_bool = False
            if self.peek() is not None and self.peek().text == "bool":
                self.next()
                return_bool = True
            on = None
            ignoring: Tuple[str, ...] = ()
            gl = gr = False
            include: Tuple[str, ...] = ()
            t2 = self.peek()
            if t2 is not None and t2.text in ("on", "ignoring"):
                which = self.next().text
                labels = self._label_list()
                if which == "on":
                    on = labels
                else:
                    ignoring = labels
                t3 = self.peek()
                if t3 is not None and t3.text in ("group_left", "group_right"):
                    which = self.next().text
                    gl = which == "group_left"
                    gr = which == "group_right"
                    if self.peek() is not None and self.peek().text == "(":
                        include = self._label_list()
            if assoc == "right":
                rhs = self.parse_expr(level)  # right-assoc recursion
            else:
                rhs = self.parse_expr(level + 1)
            lhs = BinOp(op, lhs, rhs, return_bool, on, ignoring, gl, gr,
                        include, pos=op_tok.pos, end=op_tok.end)
            lhs = self._postfix(lhs)
            if assoc == "right":
                break
        return lhs

    def _label_list(self) -> Tuple[str, ...]:
        self.expect("(")
        labels = []
        while not self.accept(")"):
            t = self.next()
            if t.kind not in ("IDENT",):
                raise ParseError(f"expected label name, got {t.text!r}",
                                 pos=t.pos, end=t.end)
            labels.append(t.text)
            if not self.accept(","):
                self.expect(")")
                break
        return tuple(labels)

    def parse_unary(self):
        t = self.peek()
        if t is not None and t.text in ("+", "-"):
            self.next()
            inner = self.parse_unary()
            if t.text == "-":
                if isinstance(inner, NumLit):
                    return NumLit(-inner.value, pos=t.pos,
                                  end=getattr(inner, "end", -1))
                return Unary("-", inner, pos=t.pos,
                             end=getattr(inner, "end", -1))
            return inner
        return self.parse_postfix()

    def parse_postfix(self):
        e = self.parse_primary()
        return self._postfix(e)

    def _postfix(self, e):
        while True:
            t = self.peek()
            if t is None:
                break
            if t.text == "[":
                self.next()
                d = self.next()
                window = self._duration_token(d, "duration")
                if window <= 0:
                    # a zero/empty window selects nothing a range
                    # function could ever evaluate — reject at parse
                    # time instead of returning all-NaN at eval time
                    raise ParseError(
                        f"zero-length range window {d.text!r}",
                        pos=d.pos, end=d.end)
                if self.accept(":"):
                    step = None
                    nt = self.peek()
                    if nt is not None and nt.text != "]":
                        sd = self.next()
                        step = self._duration_token(sd, "subquery step")
                        if step <= 0:
                            # Prometheus rejects explicit zero subquery
                            # resolution ([5m:0s]) — pinned behavior
                            raise ParseError(
                                f"zero subquery step {sd.text!r}",
                                pos=sd.pos, end=sd.end)
                    self.expect("]")
                    e = Subquery(e, window, step,
                                 pos=getattr(e, "pos", t.pos),
                                 end=self._last_end())
                else:
                    self.expect("]")
                    if not isinstance(e, Selector):
                        raise ParseError(
                            "range selector applies only to vector selectors",
                            pos=t.pos, end=self._last_end())
                    e.window_ms = window
                    e.end = self._last_end()
            elif t.text == "offset":
                self.next()
                d = self.next()
                sign = 1
                if d.text == "-":
                    sign = -1
                    d = self.next()
                off = self._duration_token(d, "offset duration")
                off *= sign
                if isinstance(e, Selector):
                    e.offset_ms = off
                elif isinstance(e, Subquery):
                    e.offset_ms = off
                else:
                    raise ParseError("offset applies to selectors",
                                     pos=t.pos, end=d.end)
                e.end = self._last_end()
            elif t.text == "@":
                self.next()
                at = self.next()
                if at.text in ("start", "end"):
                    # @ start() / @ end() (LogicalPlan.scala:349 pins to
                    # the query range; resolved at plan conversion)
                    self.expect("(")
                    self.expect(")")
                    at_ms: object = at.text
                else:
                    sign = 1
                    if at.text == "-":
                        sign = -1
                        at = self.next()
                    at_ms = sign * int(float(at.text) * 1000)
                if isinstance(e, (Selector, Subquery)):
                    e.at_ms = at_ms
                    e.end = self._last_end()
                else:
                    raise ParseError(
                        "@ modifier is only supported on vector and range "
                        "selectors and subqueries",
                        pos=t.pos, end=self._last_end())
            else:
                break
        return e

    def _duration_token(self, d: Token, what: str) -> int:
        """ms value of a DURATION/NUMBER token, with a spanned error on
        anything else (the old path crashed on malformed text)."""
        try:
            if d.kind == "DURATION":
                return parse_duration_ms(d.text)
            if d.kind == "NUMBER":
                return int(float(d.text) * 1000)
        except ValueError:
            pass
        raise ParseError(f"expected {what}, got {d.text!r}",
                         pos=d.pos, end=d.end)

    def parse_primary(self):
        t = self.peek()
        if t is None:
            raise ParseError("unexpected end of query", pos=self._eof_pos())
        if t.text == "(":
            self.next()
            e = self.parse_expr(0)
            self.expect(")")
            return e
        if t.kind == "NUMBER":
            self.next()
            txt = t.text.lower()
            if txt.startswith("0x"):
                return NumLit(float(int(txt, 16)), pos=t.pos, end=t.end)
            if txt == "inf":
                return NumLit(float("inf"), pos=t.pos, end=t.end)
            if txt == "nan":
                return NumLit(float("nan"), pos=t.pos, end=t.end)
            return NumLit(float(t.text), pos=t.pos, end=t.end)
        if t.kind == "STRING":
            self.next()
            return StrLit(_unquote(t.text), pos=t.pos, end=t.end)
        if t.kind == "DURATION":
            # bare duration as number of seconds (PromQL durations-as-numbers)
            self.next()
            return NumLit(parse_duration_ms(t.text) / 1000.0,
                          pos=t.pos, end=t.end)
        if t.text == "{":
            return self._selector(None, t.pos)
        if t.kind == "IDENT":
            # aggregation with leading grouping: sum by (x) (...)
            if t.text in AGG_OPS and t.text != "absent_hack":
                return self._aggregation()
            nxt = self.peek(1)
            if nxt is not None and nxt.text == "(" and _is_function(t.text):
                return self._call()
            self.next()
            return self._selector(t.text, t.pos)
        raise ParseError(f"unexpected token {t.text!r}", pos=t.pos,
                         end=t.end)

    def _selector(self, metric: Optional[str], pos: int = -1) -> Selector:
        column = None
        if metric and "::" in metric:
            metric, column = metric.split("::", 1)
        matchers: List[Matcher] = []
        if self.peek() is not None and self.peek().text == "{":
            self.next()
            while not self.accept("}"):
                lt = self.next()
                if lt.kind not in ("IDENT",) and not lt.kind == "STRING":
                    raise ParseError(f"expected label, got {lt.text!r}",
                                     pos=lt.pos, end=lt.end)
                label = lt.text
                opt = self.next()
                if opt.text not in ("=", "!=", "=~", "!~"):
                    raise ParseError(f"bad matcher op {opt.text!r}",
                                     pos=opt.pos, end=opt.end)
                vt = self.next()
                if vt.kind != "STRING":
                    raise ParseError("matcher value must be a string",
                                     pos=vt.pos, end=vt.end)
                matchers.append(Matcher(label, opt.text, _unquote(vt.text)))
                if not self.accept(","):
                    self.expect("}")
                    break
        if metric is None and not matchers:
            raise ParseError("empty selector", pos=pos,
                             end=self._last_end())
        return Selector(metric, matchers, column=column, pos=pos,
                        end=self._last_end())

    def _aggregation(self) -> Agg:
        op_tok = self.next()
        op = op_tok.text
        by: Tuple[str, ...] = ()
        without: Tuple[str, ...] = ()
        t = self.peek()
        if t is not None and t.text in ("by", "without"):
            which = self.next().text
            labels = self._label_list()
            if which == "by":
                by = labels
            else:
                without = labels
        self.expect("(")
        args: List = []
        while True:
            args.append(self.parse_expr(0))
            if not self.accept(","):
                break
        self.expect(")")
        t = self.peek()
        if t is not None and t.text in ("by", "without"):
            which = self.next().text
            labels = self._label_list()
            if which == "by":
                by = labels
            else:
                without = labels
        params = args[:-1]
        expr = args[-1]
        if op in AGG_PARAM_OPS and len(args) < 2:
            raise ParseError(f"{op} requires a parameter",
                             pos=op_tok.pos, end=op_tok.end)
        return Agg(op, expr, params, by, without, pos=op_tok.pos,
                   end=self._last_end())

    def _call(self) -> Call:
        name_tok = self.next()
        name = name_tok.text
        self.expect("(")
        args: List = []
        if not self.accept(")"):
            while True:
                args.append(self.parse_expr(0))
                if not self.accept(","):
                    break
            self.expect(")")
        return Call(name, args, pos=name_tok.pos, end=self._last_end())


def _is_function(name: str) -> bool:
    return (name in RANGE_FN_NAMES or name in INSTANT_FNS or
            name in MISC_FNS or
            name in ("scalar", "vector", "time", "absent", "sort",
                     "sort_desc", "limit", "rate", "timestamp", "pi"))


def _unquote(s: str) -> str:
    if s[0] == "`":
        return s[1:-1]
    body = s[1:-1]
    return bytes(body, "utf-8").decode("unicode_escape")


# ---------------------------------------------------------------------------
# AST -> LogicalPlan
# ---------------------------------------------------------------------------

def _matchers_to_filters(sel: Selector) -> Tuple[ColumnFilter, ...]:
    filters: List[ColumnFilter] = []
    if sel.metric:
        filters.append(ColumnFilter.eq(METRIC_COLUMN, sel.metric))
    for m in sel.matchers:
        label = METRIC_COLUMN if m.label == "__name__" else m.label
        if m.op == "=":
            filters.append(ColumnFilter.eq(label, m.value))
        elif m.op == "!=":
            filters.append(ColumnFilter.neq(label, m.value))
        elif m.op == "=~":
            filters.append(ColumnFilter.regex(label, m.value))
        elif m.op == "!~":
            filters.append(ColumnFilter.not_regex(label, m.value))
    return tuple(filters)


@dataclass
class TimeStepParams:
    """start/step/end in SECONDS (HTTP API units, prometheus TimeStepParams).
    """
    start_s: int
    step_s: int
    end_s: int


class PlanBuilder:
    def __init__(self, start_ms: int, step_ms: int, end_ms: int,
                 lookback_ms: int = DEFAULT_LOOKBACK_MS):
        self.start_ms = start_ms
        self.step_ms = max(step_ms, 1)
        self.end_ms = end_ms
        self.lookback_ms = lookback_ms

    def build(self, ast) -> lp.LogicalPlan:
        return self._vec(ast)

    def _resolve_at(self, at) -> Optional[int]:
        """@ modifier value -> pinned ms (start()/end() pin to the query
        range, LogicalPlan.scala:349 / ast/SubqueryUtils)."""
        if at == "start":
            return self.start_ms
        if at == "end":
            return self.end_ms
        return at

    # -- scalar plans -----------------------------------------------------
    def _scalar(self, ast) -> lp.LogicalPlan:
        if isinstance(ast, NumLit):
            return lp.ScalarFixedDoublePlan(ast.value, self.start_ms,
                                            self.step_ms, self.end_ms)
        if isinstance(ast, Unary) and ast.op == "-":
            inner = self._scalar(ast.expr)
            return lp.ScalarBinaryOperation(
                "-", 0.0, inner, self.start_ms, self.step_ms, self.end_ms)
        if isinstance(ast, Call) and ast.name == "time":
            return lp.ScalarTimeBasedPlan("time", self.start_ms, self.step_ms,
                                          self.end_ms)
        if isinstance(ast, Call) and ast.name == "pi":
            import math
            return lp.ScalarFixedDoublePlan(math.pi, self.start_ms,
                                            self.step_ms, self.end_ms)
        if isinstance(ast, Call) and ast.name == "scalar":
            return lp.ScalarVaryingDoublePlan(self._vec(ast.args[0]))
        if isinstance(ast, BinOp) and self._is_scalar(ast.lhs) and \
                self._is_scalar(ast.rhs):
            return lp.ScalarBinaryOperation(
                ast.op, self._scalar(ast.lhs), self._scalar(ast.rhs),
                self.start_ms, self.step_ms, self.end_ms)
        raise ParseError(f"expected scalar expression, got {ast}")

    def _is_scalar(self, ast) -> bool:
        if isinstance(ast, NumLit):
            return True
        if isinstance(ast, Unary):
            return self._is_scalar(ast.expr)
        if isinstance(ast, Call) and ast.name in ("time", "scalar", "pi"):
            return True
        if isinstance(ast, BinOp):
            return self._is_scalar(ast.lhs) and self._is_scalar(ast.rhs)
        return False

    def _const(self, ast) -> float:
        if isinstance(ast, NumLit):
            return ast.value
        if isinstance(ast, Unary) and ast.op == "-":
            return -self._const(ast.expr)
        if isinstance(ast, StrLit):
            return ast.value  # type: ignore[return-value]
        raise ParseError(f"expected constant, got {ast}")

    # -- vector plans -----------------------------------------------------
    def _vec(self, ast) -> lp.LogicalPlan:
        if isinstance(ast, Selector):
            if ast.window_ms is not None:
                raise ParseError(
                    "range vector must be wrapped in a range function")
            raw = lp.RawSeriesPlan(
                _matchers_to_filters(ast),
                self.start_ms - self.lookback_ms - ast.offset_ms,
                self.end_ms - ast.offset_ms,
                column=ast.column, offset_ms=ast.offset_ms)
            return lp.PeriodicSeries(raw, self.start_ms, self.step_ms,
                                     self.end_ms, self.lookback_ms,
                                     ast.offset_ms,
                                     self._resolve_at(ast.at_ms))
        if isinstance(ast, Agg):
            inner = self._vec(ast.expr)
            params = tuple(self._const(p) for p in ast.params)
            return lp.Aggregate(ast.op, inner, params, ast.by, ast.without)
        if isinstance(ast, Call):
            return self._call_plan(ast)
        if isinstance(ast, BinOp):
            return self._binop_plan(ast)
        if isinstance(ast, Unary):
            inner = self._vec(ast.expr)
            return lp.ScalarVectorBinaryOperation(
                "-", lp.ScalarFixedDoublePlan(0.0, self.start_ms,
                                              self.step_ms, self.end_ms),
                inner, scalar_is_lhs=True)
        if isinstance(ast, NumLit):
            # bare scalar at vector position
            return lp.ScalarFixedDoublePlan(ast.value, self.start_ms,
                                            self.step_ms, self.end_ms)
        if isinstance(ast, Subquery):
            raise ParseError(
                "subquery must be wrapped in a range function")
        raise ParseError(f"cannot convert {ast} to plan")

    def _call_plan(self, ast: Call) -> lp.LogicalPlan:
        name = ast.name
        if name in ("sort", "sort_desc"):
            return lp.ApplySortFunction(self._vec(ast.args[0]),
                                        descending=(name == "sort_desc"))
        if name == "limit":
            return lp.ApplyLimitFunction(self._vec(ast.args[1]),
                                         int(self._const(ast.args[0])))
        if name == "absent":
            inner_ast = ast.args[0]
            filters = _matchers_to_filters(inner_ast) \
                if isinstance(inner_ast, Selector) else ()
            return lp.ApplyAbsentFunction(
                self._vec(inner_ast), tuple(filters), self.start_ms,
                self.step_ms, self.end_ms)
        if name == "vector":
            return lp.VectorPlan(self._scalar(ast.args[0]))
        if name == "scalar":
            return lp.ScalarVaryingDoublePlan(self._vec(ast.args[0]))
        if name == "time":
            return lp.ScalarTimeBasedPlan("time", self.start_ms, self.step_ms,
                                          self.end_ms)
        if name in MISC_FNS:
            inner = self._vec(ast.args[0])
            str_args = tuple(self._const(a) for a in ast.args[1:])
            return lp.ApplyMiscellaneousFunction(inner, name, str_args)
        if name in RANGE_FN_NAMES:
            return self._range_fn_plan(ast)
        if name in INSTANT_FNS:
            # arg order: histogram_quantile(q, v); clamp(v, a, b); round(v, n)
            if name in INSTANT_FN_SCALAR_FIRST:
                scalar_args = (self._const(ast.args[0]),)
                inner = self._vec(ast.args[1])
            else:
                inner = self._vec(ast.args[0])
                scalar_args = tuple(self._const(a) for a in ast.args[1:])
            return lp.ApplyInstantFunction(inner, name, scalar_args)
        raise ParseError(f"unknown function {name}")

    def _range_fn_plan(self, ast: Call) -> lp.LogicalPlan:
        name = ast.name
        fn = RANGE_FN_NAMES[name]
        args = list(ast.args)
        scalars: List[float] = []
        if name in RANGE_FN_SCALAR_FIRST:
            scalars.append(self._const(args.pop(0)))
        if name in RANGE_FN_SCALAR_AFTER:
            scalars.extend(self._const(a) for a in args[1:])
            args = args[:1]
        rv = args[0]
        if isinstance(rv, Selector):
            if rv.window_ms is None:
                raise ParseError(f"{name} expects a range vector")
            raw = lp.RawSeriesPlan(
                _matchers_to_filters(rv),
                self.start_ms - rv.window_ms - rv.offset_ms,
                self.end_ms - rv.offset_ms,
                column=rv.column, offset_ms=rv.offset_ms)
            return lp.PeriodicSeriesWithWindowing(
                raw, fn, rv.window_ms, self.start_ms, self.step_ms,
                self.end_ms, tuple(scalars), rv.offset_ms,
                self._resolve_at(rv.at_ms))
        if isinstance(rv, Subquery):
            sub_step = rv.step_ms if rv.step_ms else self.step_ms
            inner = self._vec(rv.expr)  # placeholder range; engine rewrites
            return lp.SubqueryWithWindowing(
                inner, fn, rv.window_ms, sub_step, self.start_ms,
                self.step_ms, self.end_ms, tuple(scalars), rv.offset_ms,
                self._resolve_at(rv.at_ms))
        raise ParseError(f"{name} expects a range vector argument")

    def _binop_plan(self, ast: BinOp) -> lp.LogicalPlan:
        lhs_scalar = self._is_scalar(ast.lhs)
        rhs_scalar = self._is_scalar(ast.rhs)
        if lhs_scalar and rhs_scalar:
            return lp.ScalarBinaryOperation(
                ast.op, self._scalar(ast.lhs), self._scalar(ast.rhs),
                self.start_ms, self.step_ms, self.end_ms)
        if lhs_scalar or rhs_scalar:
            scalar = self._scalar(ast.lhs if lhs_scalar else ast.rhs)
            vector = self._vec(ast.rhs if lhs_scalar else ast.lhs)
            return lp.ScalarVectorBinaryOperation(
                ast.op, scalar, vector, scalar_is_lhs=lhs_scalar,
                return_bool=ast.return_bool)
        card = "one-to-one"
        if ast.group_left:
            card = "many-to-one"
        elif ast.group_right:
            card = "one-to-many"
        return lp.BinaryJoin(
            self._vec(ast.lhs), ast.op, self._vec(ast.rhs), card,
            ast.on, ast.ignoring, ast.include, ast.return_bool)


# ---------------------------------------------------------------------------
# Public API (parse/Parser.scala:183 queryRangeToLogicalPlan equivalent)
# ---------------------------------------------------------------------------

def parse_query_range(query: str, params: TimeStepParams,
                      lookback_ms: int = DEFAULT_LOOKBACK_MS
                      ) -> lp.LogicalPlan:
    ast = Parser(query).parse()
    b = PlanBuilder(params.start_s * 1000, params.step_s * 1000,
                    params.end_s * 1000, lookback_ms)
    return b.build(ast)


def parse_query(query: str, time_s: int,
                lookback_ms: int = DEFAULT_LOOKBACK_MS) -> lp.LogicalPlan:
    """Instant query at one timestamp (step=0 -> single step)."""
    return parse_query_range(query, TimeStepParams(time_s, 1, time_s),
                             lookback_ms)


def _fmt_num(v: float) -> str:
    if v != v:
        return "NaN"
    if v in (float("inf"), float("-inf")):
        return "Inf" if v > 0 else "-Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _fmt_dur(ms: int) -> str:
    return f"{int(ms)}ms"


def _quote(s: str) -> str:
    return '"' + s.replace("\\", "\\\\").replace('"', '\\"') + '"'


def ast_to_text(ast) -> str:
    """Canonical (normalized) rendering of a parsed AST: one spacing,
    sorted matchers/grouping labels, ms-unit durations, explicit parens.
    Two queries with the same rendering are SYNTACTICALLY equivalent
    modulo whitespace/comments/label order — the rules loader's
    duplicate detection compares these instead of raw text."""
    if isinstance(ast, NumLit):
        return _fmt_num(ast.value)
    if isinstance(ast, StrLit):
        return _quote(ast.value)
    if isinstance(ast, Unary):
        return f"(-{ast_to_text(ast.expr)})"
    if isinstance(ast, Selector):
        parts = []
        for m in sorted(ast.matchers, key=lambda m: (m.label, m.op,
                                                     m.value)):
            parts.append(f"{m.label}{m.op}{_quote(m.value)}")
        name = ast.metric or ""
        if ast.column:
            name += f"::{ast.column}"
        out = name + ("{" + ",".join(parts) + "}" if parts else
                      ("{}" if not name else ""))
        if ast.window_ms is not None:
            out += f"[{_fmt_dur(ast.window_ms)}]"
        return out + _mods(ast)
    if isinstance(ast, Subquery):
        step = _fmt_dur(ast.step_ms) if ast.step_ms else ""
        return (f"{ast_to_text(ast.expr)}[{_fmt_dur(ast.window_ms)}:"
                f"{step}]" + _mods(ast))
    if isinstance(ast, Call):
        return (f"{ast.name}(" +
                ",".join(ast_to_text(a) for a in ast.args) + ")")
    if isinstance(ast, Agg):
        grp = ""
        if ast.by:
            grp = " by (" + ",".join(sorted(ast.by)) + ") "
        elif ast.without:
            grp = " without (" + ",".join(sorted(ast.without)) + ") "
        args = list(ast.params) + [ast.expr]
        return (f"{ast.op}{grp}(" +
                ",".join(ast_to_text(a) for a in args) + ")")
    if isinstance(ast, BinOp):
        mods = []
        if ast.return_bool:
            mods.append("bool")
        if ast.on is not None:
            mods.append("on(" + ",".join(sorted(ast.on)) + ")")
        elif ast.ignoring:
            mods.append("ignoring(" + ",".join(sorted(ast.ignoring)) + ")")
        if ast.group_left or ast.group_right:
            g = "group_left" if ast.group_left else "group_right"
            if ast.include:
                g += "(" + ",".join(sorted(ast.include)) + ")"
            mods.append(g)
        mid = " ".join([ast.op] + mods)
        return f"({ast_to_text(ast.lhs)} {mid} {ast_to_text(ast.rhs)})"
    raise ValueError(f"cannot render {type(ast).__name__}")


def _mods(ast) -> str:
    out = ""
    if getattr(ast, "offset_ms", 0):
        out += f" offset {_fmt_dur(ast.offset_ms)}"
    at = getattr(ast, "at_ms", None)
    if at is not None:
        out += f" @ {at}()" if at in ("start", "end") else \
            f" @ {at / 1000.0:g}"
    return out


def normalize_query(query: str) -> str:
    """Whitespace/comment/label-order-insensitive normal form of a
    query (parses, then renders canonically). Raises ParseError on
    invalid input."""
    return ast_to_text(Parser(query).parse())


def selector_to_filters(selector: str) -> Tuple[ColumnFilter, ...]:
    """Parse a bare series selector (`metric{label="x"}`) into column
    filters — the HTTP `match[]` parameter (PrometheusApiRoute series/
    labels endpoints)."""
    ast = Parser(selector).parse()
    if not isinstance(ast, Selector):
        raise ValueError(f"not a series selector: {selector}")
    return _matchers_to_filters(ast)
