"""Span-discipline rule: ``span-discipline``.

Two invariants the tracing layer (filodb_tpu_torch.obs.trace) lives by:

  1. **Spans are opened via the context manager.** A bare
     ``start_span(...)`` call (or a span/event opened as a discarded
     expression statement) has no guaranteed close: an exception
     between open and close leaks an unfinished span and corrupts the
     thread-local parent chain. ``with span("x"): ...`` (optionally
     ``as sp``) is the only sanctioned shape.
  2. **No string formatting for span/trace attributes inside
     ``@hot_path`` code unless behind the sampling guard.** ``span()``
     is ~zero-cost when no trace is active — but its ARGUMENTS are
     evaluated unconditionally. An f-string / ``%`` / ``.format()``
     built per call re-introduces per-query allocation + formatting on
     the untraced fast path, exactly the cost the no-op design removed.
     Hoist the formatting behind ``if trace_active():`` (or
     ``...sampled``) or pass raw values and let the span store them.

Suppress a deliberate case with
``# graftlint: disable=span-discipline (reason)``.
"""

from __future__ import annotations

import ast
from typing import Iterable, List, Optional, Set

from filodb_tpu_torch.lint import Finding, ModuleSource, register_rule
from filodb_tpu_torch.lint.rules_hot import _is_hot, _module_hot_names

register_rule(
    "span-discipline", "trace",
    "bare start_span without a context manager, or string formatting "
    "for span attributes inside @hot_path code outside the sampling "
    "guard")

# call leaves that open/annotate spans (the obs.trace API surface)
from filodb_tpu_torch.lint.astwalk import walk_nodes
_SPAN_OPENERS = {"span", "event", "start_span"}
_SPAN_ANNOTATORS = {"tag"}
# names in an `if` test that count as the sampling guard
_GUARD_MARKERS = ("sampled", "trace_active", "is_traced", "active")


def _dotted(node: ast.expr) -> Optional[str]:
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = _dotted(node.value)
        return f"{base}.{node.attr}" if base else None
    return None


def _is_span_call(call: ast.Call, leaves: Set[str]) -> Optional[str]:
    """Dotted callee name when ``call`` targets the span API (final
    component in ``leaves``, and for bare/ambiguous receivers the path
    must smell like the trace module), else None."""
    dotted = _dotted(call.func)
    if dotted is None:
        return None
    parts = dotted.split(".")
    leaf = parts[-1]
    if leaf not in leaves:
        return None
    if len(parts) == 1:
        return dotted       # bare `span(...)` / `start_span(...)`
    base = ".".join(parts[:-1]).lower()
    if "trace" in base or "tracer" in base or leaf == "start_span" \
            or leaf == "tag":
        return dotted
    return None


def _has_string_formatting(node: ast.expr) -> bool:
    for sub in ast.walk(node):
        if isinstance(sub, ast.JoinedStr):
            return True     # f-string
        if isinstance(sub, ast.BinOp) and isinstance(sub.op, ast.Mod):
            # "..." % args (left side a literal or plausible string)
            if isinstance(sub.left, ast.Constant) \
                    and isinstance(sub.left.value, str):
                return True
        if isinstance(sub, ast.Call):
            f = sub.func
            if isinstance(f, ast.Attribute) and f.attr == "format":
                return True
            if isinstance(f, ast.Name) and f.id in ("str", "repr"):
                return True
    return False


def _guarded(test: ast.expr) -> bool:
    """True when an `if` test reads like the sampling guard."""
    for sub in ast.walk(test):
        name = None
        if isinstance(sub, ast.Attribute):
            name = sub.attr
        elif isinstance(sub, ast.Name):
            name = sub.id
        if name and any(m in name.lower() for m in _GUARD_MARKERS):
            return True
    return False


def check_module(mod: ModuleSource) -> Iterable[Finding]:
    findings: List[Finding] = []
    hot_names = _module_hot_names(mod.tree)

    # -- invariant 1: context-manager discipline, whole module ----------
    with_ctx_calls: Set[int] = set()
    for node in walk_nodes(mod.tree):
        if isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                expr = item.context_expr
                if isinstance(expr, ast.Call):
                    with_ctx_calls.add(id(expr))
    for node in walk_nodes(mod.tree):
        if not isinstance(node, ast.Call):
            continue
        dotted = _is_span_call(node, {"start_span"})
        if dotted is not None and id(node) not in with_ctx_calls:
            findings.append(Finding(
                rule="span-discipline", path=mod.relpath,
                line=node.lineno,
                message=f"bare {dotted}() — spans must be opened via "
                        f"the context manager (`with span(...):`); an "
                        f"exception between open and close leaks the "
                        f"span",
                context=f"bare-open:{dotted}:{node.lineno}"))
    # a span/event opened as a DISCARDED expression statement is the
    # same leak (event() is exempt: it is a point annotation that
    # records immediately and returns nothing to close)
    for node in walk_nodes(mod.tree):
        if isinstance(node, ast.Expr) and isinstance(node.value, ast.Call):
            dotted = _is_span_call(node.value, {"span"})
            if dotted is not None:
                findings.append(Finding(
                    rule="span-discipline", path=mod.relpath,
                    line=node.lineno,
                    message=f"{dotted}() opened and discarded — use "
                            f"`with {dotted}(...):` so the span closes",
                    context=f"discarded:{dotted}:{node.lineno}"))

    # -- invariant 2: no per-call formatting in @hot_path span args -----
    hot_fns = [n for n in walk_nodes(mod.tree)
               if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
               and _is_hot(n, hot_names)]

    def visit(node: ast.AST, guarded: bool, fn) -> None:
        if isinstance(node, ast.If):
            body_guarded = guarded or _guarded(node.test)
            for child in node.body:
                visit(child, body_guarded, fn)
            for child in node.orelse:
                visit(child, guarded, fn)
            return
        if isinstance(node, ast.Call):
            dotted = _is_span_call(
                node, _SPAN_OPENERS | _SPAN_ANNOTATORS)
            if dotted is not None and not guarded:
                args = list(node.args) + [kw.value for kw in
                                          node.keywords]
                if any(_has_string_formatting(a) for a in args):
                    findings.append(Finding(
                        rule="span-discipline", path=mod.relpath,
                        line=node.lineno,
                        message=f"string formatting in {dotted}() "
                                f"arguments inside hot-path function "
                                f"{fn.name!r}: span args evaluate even "
                                f"when tracing is off — guard with "
                                f"`if trace_active():` or pass raw "
                                f"values",
                        context=f"hot-format:{fn.name}:{node.lineno}"))
        for child in ast.iter_child_nodes(node):
            visit(child, guarded, fn)

    for fn in hot_fns:
        for stmt in fn.body:
            visit(stmt, False, fn)
    return findings
