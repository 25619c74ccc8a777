"""promlint: semantic analysis of the PromQL surface.

This module checks the *query language*. It runs over the parsed
AST (:mod:`filodb_tpu_torch.promql.parser` — the exact grammar the engine
evaluates, no second parser to drift) and emits spanned
:class:`Diagnostic` findings in three families:

* **Type & schema checking** — every node gets a type from
  ``{scalar, string, instant vector, range vector}``; range functions
  require range-vector arguments, aggregations require instant
  vectors, subquery inners must be instant vectors, binary-operator
  operand rules and ``bool``-modifier placement are enforced.
  Counter/gauge semantics resolve through a :class:`MetricSchemas`
  (ingest-schema suffix heuristic + explicit ``schema:`` declarations
  from rule files): ``rate()`` on an explicitly gauge-schema metric is
  an ERROR; ``delta()``/``deriv()`` on a counter is a WARNING.

* **Label dataflow** — the statically-known label set propagates
  through ``by``/``without`` aggregations and ``on``/``ignoring``/
  ``group_*`` vector matching. Matching on a label an upstream
  aggregation provably dropped is an ERROR; a provably-ambiguous
  many-to-many match with no ``group_*`` modifier is a WARNING.

* **Static cost bounds** — :func:`static_cost_bound` computes a
  per-node cost lattice over the LogicalPlan (steps x window/step
  overlap x cardinality upper bound via
  ``TagIndex.posting_upper_bound``) that is guaranteed to upper-bound
  :func:`filodb_tpu_torch.query.qos.estimate_plan_cost`'s runtime price for
  the same plan — cross-checked in tests so the QoS admission price
  can never silently under-charge a plan shape.

Suppression: a query may carry an in-query pragma comment
``# promlint: disable=<rule>[,<rule>] (reason)``; a reason string is
required. The pragma
scopes to the whole expression (queries are single expressions).

The inversion that turns this from a linter into a correctness rail
lives in the JAX package: ``filodb_tpu.promql.gen`` generates random
queries *through these typing rules* (well-typed by construction) and
``filodb_tpu.promql.refeval`` is the obviously-correct reference those
queries are differentially checked against. The port has neither module
yet (ROADMAP A.12 ports them).
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from filodb_tpu_torch.promql import parser as pp
from filodb_tpu_torch.query.rangefn import (COUNTER_FUNCTIONS, GAUGE_FUNCTIONS,
                                      RANGE_FN_SCALAR_ARITY)

ERROR = "error"
WARNING = "warning"

# -- types ------------------------------------------------------------------

SCALAR = "scalar"
STRING = "string"
INSTANT = "instant vector"
RANGE = "range vector"

_METRIC_LABELS = ("_metric_", "__name__")

_PRAGMA_RE = re.compile(
    r"#\s*promlint:\s*disable=([\w\-,]+)\s*(?:\(([^)]*)\))?")


@dataclass(frozen=True)
class Diagnostic:
    """One semantic finding at a character span of the query text."""
    rule: str
    message: str
    pos: int = -1
    end: int = -1
    severity: str = ERROR

    def render(self, query: Optional[str] = None) -> str:
        loc = f"col {self.pos}" if self.pos >= 0 else "?"
        head = f"[{self.rule}] {self.message} (at {loc})"
        if query is None or self.pos < 0:
            return head
        width = max(1, min(self.end, len(query)) - self.pos)
        return f"{head}\n  {query}\n  {' ' * self.pos}{'^' * width}"


# -- rule catalog ------------------------------------------------------------

RULES: Dict[str, Tuple[str, str]] = {
    "promql-syntax": (ERROR, "the query does not parse"),
    "promql-range-arg": (ERROR,
                         "a range function requires a range-vector "
                         "argument ([window] selector or subquery)"),
    "promql-instant-arg": (ERROR,
                           "an aggregation / instant function requires "
                           "an instant-vector argument"),
    "promql-scalar-arg": (ERROR,
                          "a function parameter must be a scalar "
                          "(number) expression"),
    "promql-string-arg": (ERROR,
                          "a function parameter must be a string "
                          "literal"),
    "promql-arity": (ERROR, "wrong number of arguments to a function"),
    "promql-subquery-inner": (ERROR,
                              "a subquery body must be an instant-"
                              "vector expression"),
    "promql-top-level-range": (ERROR,
                               "a query must not evaluate to a bare "
                               "range vector; wrap it in a range "
                               "function"),
    "promql-bool-modifier": (ERROR,
                             "the bool modifier applies only to "
                             "comparison operators"),
    "promql-cmp-scalar-needs-bool": (ERROR,
                                     "a scalar-to-scalar comparison "
                                     "requires the bool modifier"),
    "promql-setop-operand": (ERROR,
                             "set operators (and/or/unless) require "
                             "instant-vector operands"),
    "promql-string-operand": (ERROR,
                              "binary operators do not apply to "
                              "string operands"),
    "promql-matching-with-scalar": (ERROR,
                                    "vector matching (on/ignoring/"
                                    "group_*) requires vector operands "
                                    "on both sides"),
    "promql-counter-fn-on-gauge": (ERROR,
                                   "rate()/increase()/irate()/resets() "
                                   "on a metric whose declared schema "
                                   "is gauge"),
    "promql-gauge-fn-on-counter": (WARNING,
                                   "delta()/idelta()/deriv() on a "
                                   "counter ignores resets — use the "
                                   "rate family"),
    "promql-match-on-dropped-label": (ERROR,
                                      "vector matching on a label an "
                                      "upstream aggregation provably "
                                      "dropped"),
    "promql-include-dropped-label": (WARNING,
                                     "group_left/right include-label "
                                     "provably dropped on the 'one' "
                                     "side"),
    "promql-many-to-many": (WARNING,
                            "vector match key provably cannot "
                            "distinguish series on either side; a "
                            "many-to-many match fails at eval time "
                            "without group_left/group_right"),
    "promql-by-absent-label": (WARNING,
                               "grouping by a label the inner "
                               "expression provably cannot carry"),
    "promql-unknown-function": (ERROR, "unknown function name"),
    "promql-pragma-no-reason": (ERROR,
                                "a promlint disable pragma must carry "
                                "a (reason) string"),
    "promql-pragma-unknown-rule": (ERROR,
                                   "a pragma disables a rule id that "
                                   "does not exist"),
}


# -- metric schema resolution ----------------------------------------------

_COUNTER_SUFFIX_RE = re.compile(r".*(_total|_count|_sum|_bucket)$")


class MetricSchemas:
    """Metric name -> ingest schema kind ("counter" | "gauge" |
    "histogram" | "delta-counter"). Explicit entries come from the rule
    file's ``schema:`` extension or the ingest schema registry;
    everything else falls back to the counter-suffix heuristic the
    selfmon rail uses (``*_total``/``_count``/``_sum``/``_bucket`` ->
    counter). ``resolve`` returns ``(kind | None, explicit)`` —
    severity policy keys off ``explicit`` (a heuristic guess must
    never hard-fail a query)."""

    def __init__(self, explicit: Optional[Dict[str, str]] = None):
        self.explicit = dict(explicit or {})

    def declare(self, metric: str, kind: str) -> None:
        self.explicit[metric] = kind

    @classmethod
    def from_rule_groups(cls, groups) -> "MetricSchemas":
        """Seed from parsed rule groups: every recording rule's output
        series gets its declared ``schema:`` (or stays heuristic)."""
        out = cls()
        for g in groups:
            for r in getattr(g, "rules", ()):
                if getattr(r, "kind", "") == "recording" and \
                        getattr(r, "schema", None):
                    out.declare(r.name, r.schema)
        return out

    def resolve(self, metric: Optional[str]
                ) -> Tuple[Optional[str], bool]:
        if not metric:
            return None, False
        kind = self.explicit.get(metric)
        if kind is not None:
            return kind, True
        if _COUNTER_SUFFIX_RE.match(metric):
            return "counter", False
        return None, False


# -- label dataflow lattice -------------------------------------------------

@dataclass(frozen=True)
class LabelInfo:
    """Statically-known label facts about a vector expression.

    ``upper`` is the CLOSED upper set of labels the result can carry
    (None = open — any label may appear). A ``by (a, b)`` aggregation
    closes the set to exactly {a, b}; ``without`` subtracts from
    whatever the inner carries. ``known`` is the set of labels that
    are definitely present-and-pinned (equality matchers)."""
    known: frozenset = frozenset()
    upper: Optional[frozenset] = None     # None = open world

    def may_carry(self, label: str) -> bool:
        return self.upper is None or label in self.upper

    def drop(self, labels) -> "LabelInfo":
        s = frozenset(labels)
        return LabelInfo(self.known - s,
                         None if self.upper is None else self.upper - s)

    def add(self, label: str) -> "LabelInfo":
        return LabelInfo(self.known,
                         None if self.upper is None
                         else self.upper | {label})


_OPEN = LabelInfo()

# -- function signature tables ---------------------------------------------

# instant functions: (scalar-arg count before vector?, scalars after)
_INSTANT_ARITY: Dict[str, Tuple[int, int]] = {
    # name -> (min extra scalars, max extra scalars) after the vector
    "clamp": (2, 2), "clamp_min": (1, 1), "clamp_max": (1, 1),
    "round": (0, 1),
}
# (scalar, vector) ordered instant functions all take exactly 2 args
_SCALAR_FIRST = set(pp.INSTANT_FN_SCALAR_FIRST)

_CMP_OPS = set(pp._CMP_OPS)
_SET_OPS = {"and", "or", "unless"}


def parse_pragmas(query: str
                  ) -> Tuple[frozenset, List[Diagnostic]]:
    """Disabled-rule ids from in-query ``# promlint:`` pragma comments,
    plus meta-diagnostics (missing reason / unknown rule id)."""
    disabled: set = set()
    diags: List[Diagnostic] = []
    for m in _PRAGMA_RE.finditer(query):
        ids = {x.strip() for x in m.group(1).split(",") if x.strip()}
        if not m.group(2) or not m.group(2).strip():
            diags.append(Diagnostic(
                "promql-pragma-no-reason",
                "disable pragma without a (reason) string",
                pos=m.start(), end=m.end()))
        for rid in ids:
            if rid != "all" and rid not in RULES:
                diags.append(Diagnostic(
                    "promql-pragma-unknown-rule",
                    f"pragma disables unknown rule {rid!r}",
                    pos=m.start(), end=m.end()))
        disabled |= ids
    return frozenset(disabled), diags


class _Analyzer:
    def __init__(self, schemas: Optional[MetricSchemas] = None):
        self.schemas = schemas or MetricSchemas()
        self.diags: List[Diagnostic] = []

    # -- helpers ---------------------------------------------------------
    def _diag(self, rule: str, message: str, node) -> None:
        sev, _doc = RULES[rule]
        pos, end = pp.ast_span(node)
        self.diags.append(Diagnostic(rule, message, pos=pos, end=end,
                                     severity=sev))

    # -- walk ------------------------------------------------------------
    def walk(self, node) -> Tuple[str, LabelInfo]:
        """Returns (type, LabelInfo). Appends diagnostics as it goes;
        on a type error it reports and recovers with a plausible type
        so one mistake doesn't cascade."""
        if isinstance(node, pp.NumLit):
            return SCALAR, _OPEN
        if isinstance(node, pp.StrLit):
            return STRING, _OPEN
        if isinstance(node, pp.Unary):
            t, li = self.walk(node.expr)
            if t == STRING:
                self._diag("promql-string-operand",
                           "unary minus on a string", node)
            return (t if t in (SCALAR, INSTANT) else SCALAR), li
        if isinstance(node, pp.Selector):
            known = frozenset(m.label for m in node.matchers
                              if m.op == "=" and
                              m.label not in _METRIC_LABELS)
            li = LabelInfo(known, None)
            return (RANGE if node.window_ms is not None else INSTANT), li
        if isinstance(node, pp.Subquery):
            t, li = self.walk(node.expr)
            if t not in (INSTANT,):
                self._diag("promql-subquery-inner",
                           f"subquery body is a {t}; the engine "
                           f"evaluates subqueries over instant "
                           f"vectors only", node)
            return RANGE, li
        if isinstance(node, pp.Agg):
            return self._agg(node)
        if isinstance(node, pp.Call):
            return self._call(node)
        if isinstance(node, pp.BinOp):
            return self._binop(node)
        return INSTANT, _OPEN

    # -- aggregations ----------------------------------------------------
    def _agg(self, node: pp.Agg) -> Tuple[str, LabelInfo]:
        t, li = self.walk(node.expr)
        if t != INSTANT:
            self._diag("promql-instant-arg",
                       f"{node.op}() aggregates instant vectors, got "
                       f"a {t}", node)
        for p in node.params:
            pt, _ = self.walk(p)
            if node.op == "count_values":
                if pt != STRING:
                    self._diag("promql-string-arg",
                               f"count_values takes a string label "
                               f"name parameter, got a {pt}", node)
            elif pt != SCALAR:
                self._diag("promql-scalar-arg",
                           f"{node.op}() parameter must be a scalar, "
                           f"got a {pt}", node)
        if node.by:
            for l in node.by:
                if not li.may_carry(l) and l not in _METRIC_LABELS:
                    self._diag("promql-by-absent-label",
                               f"by({l}) — the inner expression "
                               f"provably cannot carry label {l!r}",
                               node)
            out = LabelInfo(li.known & frozenset(node.by),
                            frozenset(node.by))
        elif node.without:
            out = li.drop(node.without)
        else:
            out = LabelInfo(frozenset(), frozenset())
        if node.op == "count_values" and node.params:
            p = node.params[0]
            if isinstance(p, pp.StrLit):
                out = out.add(p.value)
        return INSTANT, out

    # -- function calls --------------------------------------------------
    def _call(self, node: pp.Call) -> Tuple[str, LabelInfo]:
        name = node.name
        nargs = len(node.args)

        def arity(lo: int, hi: Optional[int] = None) -> bool:
            hi = lo if hi is None else hi
            if not (lo <= nargs <= hi):
                want = str(lo) if lo == hi else f"{lo}..{hi}"
                self._diag("promql-arity",
                           f"{name}() takes {want} argument(s), got "
                           f"{nargs}", node)
                return False
            return True

        if name in pp.RANGE_FN_NAMES:
            return self._range_call(node, arity)
        if name in pp.INSTANT_FNS:
            return self._instant_call(node, arity)
        if name in pp.MISC_FNS:
            return self._misc_call(node, arity)
        if name in ("scalar", "absent"):
            if arity(1):
                t, li = self.walk(node.args[0])
                if t != INSTANT:
                    self._diag("promql-instant-arg",
                               f"{name}() requires an instant vector, "
                               f"got a {t}", node)
                if name == "absent":
                    inner = node.args[0]
                    known = frozenset(
                        m.label for m in getattr(inner, "matchers", ())
                        if m.op == "=" and m.label not in _METRIC_LABELS)
                    return INSTANT, LabelInfo(known, known)
            return (SCALAR if name == "scalar" else INSTANT), _OPEN
        if name == "vector":
            if arity(1):
                t, _ = self.walk(node.args[0])
                if t != SCALAR:
                    self._diag("promql-scalar-arg",
                               f"vector() requires a scalar, got a "
                               f"{t}", node)
            return INSTANT, LabelInfo(frozenset(), frozenset())
        if name in ("time", "pi"):
            arity(0)
            return SCALAR, _OPEN
        if name in ("sort", "sort_desc", "timestamp"):
            if arity(1):
                t, li = self.walk(node.args[0])
                if t != INSTANT:
                    self._diag("promql-instant-arg",
                               f"{name}() requires an instant vector, "
                               f"got a {t}", node)
                return INSTANT, li
            return INSTANT, _OPEN
        if name == "limit":
            if arity(2):
                kt, _ = self.walk(node.args[0])
                if kt != SCALAR:
                    self._diag("promql-scalar-arg",
                               "limit() k must be a scalar", node)
                t, li = self.walk(node.args[1])
                if t != INSTANT:
                    self._diag("promql-instant-arg",
                               "limit() requires an instant vector",
                               node)
                return INSTANT, li
            return INSTANT, _OPEN
        self._diag("promql-unknown-function",
                   f"unknown function {name!r}", node)
        return INSTANT, _OPEN

    def _range_call(self, node: pp.Call, arity) -> Tuple[str, LabelInfo]:
        name = node.name
        engine_name = pp.RANGE_FN_NAMES[name]
        n_scalars = RANGE_FN_SCALAR_ARITY.get(engine_name, 0)
        scalar_first = name in pp.RANGE_FN_SCALAR_FIRST
        if not arity(1 + n_scalars):
            # recover: still type-check whatever args exist
            pass
        args = list(node.args)
        rv_idx = 1 if scalar_first and args else 0
        scalar_args = [a for i, a in enumerate(args) if i != rv_idx]
        for a in scalar_args:
            t, _ = self.walk(a)
            if t != SCALAR:
                self._diag("promql-scalar-arg",
                           f"{name}() parameter must be a scalar, got "
                           f"a {t}", node)
        li = _OPEN
        if rv_idx < len(args):
            rv = args[rv_idx]
            t, li = self.walk(rv)
            if t != RANGE:
                self._diag("promql-range-arg",
                           f"{name}() expects a range vector "
                           f"(selector[window] or subquery), got a "
                           f"{t}", node)
            self._schema_check(name, engine_name, rv, node)
        return INSTANT, li

    def _schema_check(self, name: str, engine_name: str, rv,
                      node) -> None:
        """Counter/gauge semantics of the metric under a range
        function, resolved from the ingest schema."""
        metric = getattr(rv, "metric", None)
        if not isinstance(rv, pp.Selector) or not metric:
            return
        kind, explicit = self.schemas.resolve(metric)
        if kind is None:
            return
        is_counter = kind in ("counter", "histogram", "delta-counter")
        if engine_name in COUNTER_FUNCTIONS and not is_counter:
            if explicit:
                self._diag("promql-counter-fn-on-gauge",
                           f"{name}() on {metric!r} whose declared "
                           f"schema is {kind}: reset correction over "
                           f"a gauge produces garbage — use "
                           f"{'deriv' if name == 'rate' else 'delta'}"
                           f"() or fix the schema", node)
            return
        if engine_name in GAUGE_FUNCTIONS and is_counter:
            self._diag("promql-gauge-fn-on-counter",
                       f"{name}() on counter {metric!r} ignores "
                       f"counter resets — use "
                       f"{'rate' if name == 'deriv' else 'increase'}"
                       f"() instead", node)

    def _instant_call(self, node: pp.Call, arity
                      ) -> Tuple[str, LabelInfo]:
        name = node.name
        if name in _SCALAR_FIRST:
            ok = arity(2)
            li = _OPEN
            if node.args:
                t, _ = self.walk(node.args[0])
                if t != SCALAR:
                    self._diag("promql-scalar-arg",
                               f"{name}() first argument must be a "
                               f"scalar, got a {t}", node)
            if ok and len(node.args) > 1:
                t, li = self.walk(node.args[1])
                if t != INSTANT:
                    self._diag("promql-instant-arg",
                               f"{name}() requires an instant vector, "
                               f"got a {t}", node)
            return INSTANT, li
        lo, hi = _INSTANT_ARITY.get(name, (0, 0))
        ok = arity(1 + lo, 1 + hi)
        li = _OPEN
        if node.args:
            t, li = self.walk(node.args[0])
            if t != INSTANT:
                self._diag("promql-instant-arg",
                           f"{name}() requires an instant vector, got "
                           f"a {t}", node)
        for a in node.args[1:]:
            t, _ = self.walk(a)
            if t != SCALAR:
                self._diag("promql-scalar-arg",
                           f"{name}() parameter must be a scalar, got "
                           f"a {t}", node)
        return INSTANT, li

    def _misc_call(self, node: pp.Call, arity) -> Tuple[str, LabelInfo]:
        name = node.name
        if name == "label_replace":
            ok = arity(5)
        else:
            ok = arity(3, 99)
        li = _OPEN
        if node.args:
            t, li = self.walk(node.args[0])
            if t != INSTANT:
                self._diag("promql-instant-arg",
                           f"{name}() requires an instant vector, got "
                           f"a {t}", node)
        for a in node.args[1:]:
            t, _ = self.walk(a)
            if t != STRING:
                self._diag("promql-string-arg",
                           f"{name}() label arguments must be string "
                           f"literals, got a {t}", node)
        if ok and node.args and isinstance(node.args[1], pp.StrLit):
            li = li.add(node.args[1].value)
        return INSTANT, li

    # -- binary operators -------------------------------------------------
    def _binop(self, node: pp.BinOp) -> Tuple[str, LabelInfo]:
        lt, lli = self.walk(node.lhs)
        rt, rli = self.walk(node.rhs)
        for t, side in ((lt, "left"), (rt, "right")):
            if t == STRING:
                self._diag("promql-string-operand",
                           f"{node.op} on a string operand "
                           f"({side}-hand side)", node)
            elif t == RANGE:
                self._diag("promql-instant-arg",
                           f"{node.op} on a range vector "
                           f"({side}-hand side); wrap it in a range "
                           f"function", node)
        if node.return_bool and node.op not in _CMP_OPS:
            self._diag("promql-bool-modifier",
                       f"bool modifier on {node.op!r}", node)
        if node.op in _SET_OPS:
            if lt != INSTANT or rt != INSTANT:
                self._diag("promql-setop-operand",
                           f"{node.op} requires instant vectors on "
                           f"both sides (got {lt} {node.op} {rt})",
                           node)
            if node.op == "or":
                upper = None if (lli.upper is None or rli.upper is None) \
                    else lli.upper | rli.upper
                return INSTANT, LabelInfo(lli.known & rli.known, upper)
            return INSTANT, lli
        scalar_sides = (lt == SCALAR) + (rt == SCALAR)
        if scalar_sides == 2:
            if node.op in _CMP_OPS and not node.return_bool:
                self._diag("promql-cmp-scalar-needs-bool",
                           f"comparison between two scalars requires "
                           f"the bool modifier ({node.op})", node)
            return SCALAR, _OPEN
        if scalar_sides == 1:
            if node.on is not None or node.ignoring or \
                    node.group_left or node.group_right:
                self._diag("promql-matching-with-scalar",
                           "on/ignoring/group_* vector matching with "
                           "a scalar operand", node)
            return INSTANT, (rli if lt == SCALAR else lli)
        # vector <op> vector
        self._check_matching(node, lli, rli)
        if node.group_right:
            return INSTANT, rli
        return INSTANT, lli

    def _check_matching(self, node: pp.BinOp, lli: LabelInfo,
                        rli: LabelInfo) -> None:
        if node.on is not None:
            for l in node.on:
                if l in _METRIC_LABELS:
                    continue
                for li, side in ((lli, "left"), (rli, "right")):
                    if not li.may_carry(l):
                        self._diag(
                            "promql-match-on-dropped-label",
                            f"on({l}) — the {side}-hand side cannot "
                            f"carry label {l!r}: an upstream "
                            f"aggregation dropped it (carries only "
                            f"{sorted(li.upper or ())})", node)
        if node.include and (node.group_left or node.group_right):
            one = rli if node.group_left else lli
            for l in node.include:
                if not one.may_carry(l):
                    self._diag(
                        "promql-include-dropped-label",
                        f"group_*({l}) — the 'one' side cannot carry "
                        f"include label {l!r}", node)
        # provable many-to-many ambiguity: both sides closed, the match
        # key strictly coarser than both identities
        if node.group_left or node.group_right or node.op in _SET_OPS:
            return
        if node.on is None:
            return
        key = frozenset(node.on)
        sides_ambiguous = 0
        for li in (lli, rli):
            if li.upper is not None and (li.upper - key):
                sides_ambiguous += 1
        if sides_ambiguous == 2:
            self._diag(
                "promql-many-to-many",
                f"on({','.join(sorted(key))}) cannot distinguish "
                f"series that differ in "
                f"{sorted((lli.upper | rli.upper) - key)} on both "
                f"sides; a many-to-many match fails at eval time — "
                f"add group_left/group_right or extend on(...)", node)


def lint_ast(ast, query: str = "",
             schemas: Optional[MetricSchemas] = None
             ) -> List[Diagnostic]:
    """Analyze a parsed AST. ``query`` (when given) supplies pragma
    comments and better top-level spans."""
    an = _Analyzer(schemas)
    t, _li = an.walk(ast)
    if t == RANGE:
        an._diag("promql-top-level-range",
                 "the query evaluates to a bare range vector; wrap it "
                 "in a range function (e.g. rate(...), avg_over_time)",
                 ast)
    diags = an.diags
    if query:
        disabled, meta = parse_pragmas(query)
        if disabled:
            diags = [d for d in diags
                     if d.rule not in disabled and "all" not in disabled]
        diags = diags + meta
    diags.sort(key=lambda d: (d.pos, d.rule))
    return diags


def lint_query(query: str,
               schemas: Optional[MetricSchemas] = None
               ) -> List[Diagnostic]:
    """Parse + analyze one query; a syntax failure comes back as a
    single spanned ``promql-syntax`` diagnostic (never raises)."""
    try:
        ast = pp.Parser(query).parse()
    except pp.ParseError as e:
        return [Diagnostic("promql-syntax", str(e),
                           pos=getattr(e, "pos", -1),
                           end=getattr(e, "end", -1))]
    except Exception as e:    # noqa: BLE001 — a linter must not crash
        return [Diagnostic("promql-syntax", f"query rejected: {e}")]
    return lint_ast(ast, query=query, schemas=schemas)


def errors(diags: Sequence[Diagnostic]) -> List[Diagnostic]:
    return [d for d in diags if d.severity == ERROR]


# ---------------------------------------------------------------------------
# static cost bounds
# ---------------------------------------------------------------------------

@dataclass
class CostBound:
    """A static upper bound on the QoS runtime price of a plan.

    Invariant (pinned by tests/test_promql_cost_bound.py): for any
    plan over any shard set, ``bound.total >= estimate_plan_cost(plan,
    shards, metering).total``. Every factor here dominates the
    estimator's corresponding factor: per-leaf series bounds skip the
    estimator's extra-equality damping, the window factor rounds UP,
    the shape weight uses a larger per-node increment, and unknown
    grids fall back to the worst periodic grid in the plan instead of
    1. The bound rides ``&explain=analyze`` so an operator can see the
    admission headroom of a plan shape."""
    total: float
    series_ub: int
    steps_ub: int
    window_factor_ub: float
    shape_weight_ub: float
    leaves: List[Dict] = field(default_factory=list)

    def to_json(self) -> Dict:
        return {"total": round(self.total, 1),
                "seriesUpperBound": int(self.series_ub),
                "stepsUpperBound": int(self.steps_ub),
                "windowFactorUpperBound": round(self.window_factor_ub, 3),
                "shapeWeightUpperBound": round(self.shape_weight_ub, 3),
                "leaves": self.leaves}


def _leaf_series_upper_bound(filters, shards, metering) -> Tuple[int, Dict]:
    """Per-leaf series upper bound. Mirrors
    ``qos._leaf_series_estimate``'s sources but NEVER comes out below
    it: same tracker/posting inputs with the ``>> 2*extra_eq`` damping
    removed, and on remote legs BOTH the metering count and the
    unknown-leg guess are summed (the estimator takes one or the
    other)."""
    from filodb_tpu_torch.core.cardinality import SHARD_KEY_LABELS
    from filodb_tpu_torch.query.qos import _UNKNOWN_SERIES_GUESS
    eq = {f.label: str(f.value) for f in filters
          if getattr(f, "op", "") == "eq"}
    prefix: List[str] = []
    for lbl in SHARD_KEY_LABELS:
        if lbl in eq:
            prefix.append(eq[lbl])
        else:
            break
    total = 0
    found = False
    remote = 0
    detail: Dict = {"prefix": list(prefix)}
    for s in shards:
        tracker = getattr(s, "card_tracker", None)
        if tracker is None:
            if hasattr(s, "fetch_raw"):
                remote += 1
            continue
        n = tracker.series_count(prefix)
        if n is None:
            continue
        idx = getattr(s, "index", None)
        if idx is not None and hasattr(idx, "posting_upper_bound"):
            ub = idx.posting_upper_bound(filters)
            if ub is not None:
                n = min(n, ub)
        total += n
        found = True
    if remote:
        counted = None
        if metering is not None and prefix:
            counted = metering.count_for(tuple(prefix))
        total += int(counted or 0) + _UNKNOWN_SERIES_GUESS * remote
        found = True
    if not found:
        total = _UNKNOWN_SERIES_GUESS
    total = max(1, total)
    detail["seriesUpperBound"] = int(total)
    return total, detail


def static_cost_bound(plan, shards: Sequence[object],
                      metering: Optional[object] = None) -> CostBound:
    """Static price ceiling of a LogicalPlan over ``shards`` — see
    :class:`CostBound` for the dominance argument."""
    from filodb_tpu_torch.query import logical as lp
    from filodb_tpu_torch.query.planner import (plan_range, walk_leaf_filters,
                                          walk_plan_tree)
    rng = plan_range(plan)
    worst_steps = [1]
    worst_wf = [1.0]
    if rng is not None:
        start, step, end, window, _lookback = rng
        if step > 0:
            worst_steps[0] = (end - start) // step + 1
        # dominate the estimator's min-window factor with the MAX
        # window over periodic nodes, rounded up

    def visit(p):
        if isinstance(p, (lp.PeriodicSeries,
                          lp.PeriodicSeriesWithWindowing,
                          lp.SubqueryWithWindowing)):
            w = getattr(p, "window_ms", 0) or \
                getattr(p, "lookback_ms", 0)
            st = p.step_ms
            if st > 0:
                worst_steps[0] = max(worst_steps[0],
                                     (p.end_ms - p.start_ms) // st + 1)
                if w and w < (1 << 61):
                    worst_wf[0] = max(worst_wf[0],
                                      1.0 + math.ceil(w / st))
            if isinstance(p, lp.SubqueryWithWindowing):
                return False    # descend: inner grids may be denser
            return True
        return False

    walk_plan_tree(plan, visit)
    nodes = [0]
    walk_plan_tree(plan, lambda p: nodes.__setitem__(0, nodes[0] + 1))
    shape_weight_ub = 1.0 + 0.2 * max(0, nodes[0] - 1)
    leaves = walk_leaf_filters(plan)
    series_ub = 0
    leaf_details: List[Dict] = []
    for f in leaves:
        n, detail = _leaf_series_upper_bound(f, shards, metering)
        series_ub += n
        leaf_details.append(detail)
    series_ub = max(1, series_ub)
    total = (float(series_ub) * max(1, worst_steps[0]) * worst_wf[0]
             * shape_weight_ub)
    return CostBound(total=total, series_ub=series_ub,
                     steps_ub=int(worst_steps[0]),
                     window_factor_ub=float(worst_wf[0]),
                     shape_weight_ub=shape_weight_ub,
                     leaves=leaf_details)
