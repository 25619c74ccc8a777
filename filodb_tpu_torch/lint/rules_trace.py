"""Trace-safety rules of the port (counterpart of the reference's
``rules_trace``).

Scope: ``dataflow.traced``, the functions that run under a
``torch.func.vmap`` / ``torch.vmap`` / ``torch.compile`` site: the
wrapped body, the functions it calls, their lexical children, and the
functions the project binds to a parameter the body calls (today
``tilestore._vmap_grids``, whose lambda calls ``body``: the
``functools.partial`` of ``_eval_counter_slide``, ``_eval_counter_fast``
or ``_eval_counter_t`` in ``evaluate_counters_t_batch`` and of
``_eval_core`` in ``evaluate_aligned_batch``). The batched parameters
(``dataflow.batched``) are those the transform feeds: the lambda's own,
at the positions past a partial's bound arguments, and what they are
passed on as.

Inside traced functions the rules flag:

  * ``trace-side-effect`` — host work that runs once per transform call
    instead of per member, or not at all under ``torch.compile``:
    ``time``-family reads, ``print``, stdlib and numpy ``random``,
    ``open``/``input``/``os.urandom``.
  * ``trace-tracer-leak`` — host escapes that raise under
    ``torch.func.vmap``: ``.item()``, ``.tolist()``, ``.numpy()``, and
    ``bool()``/``int()``/``float()`` of a value computed from a batched
    parameter (or such a parameter formatted into an f-string).
  * ``trace-mutate-capture`` — in-place writes (``x.add_()``, ``x[...] =
    ``, ``.copy_``) into a captured tensor, and mutation of a captured
    container: a name neither local to the function (or a lexical
    ancestor) nor one of its batched parameters, such as a parameter a
    ``functools.partial`` bound before the transform.

Code on the scalar branch of an ``isinstance(x, torch.Tensor)`` test (the
``else`` of ``if isinstance(...)``, the body of ``if not
isinstance(...)``) is skipped: under ``torch.func.vmap`` a batched value
is always a tensor, so that branch runs only when the function is called
eagerly with Python scalars (``_eval_counter_slide``'s
``int(np.floor(...))``).

Not ported (``NOT_PORTED``): ``trace-f64-constant`` exists because Mosaic
cannot legalise 64-bit vectors in a Pallas body; CUDA has no such limit.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Sequence, Set, Tuple

from filodb_tpu_torch.lint import Finding, ModuleSource, register_rule
from filodb_tpu_torch.lint import callgraph as cgmod
from filodb_tpu_torch.lint import dataflow as dfmod
from filodb_tpu_torch.lint.astwalk import walk_nodes

register_rule("trace-side-effect", "trace",
              "Python side effect inside a torch.func.vmap/compile-traced "
              "function")
register_rule("trace-tracer-leak", "trace",
              "batched value escapes to the host: .item(), .tolist(), "
              ".numpy(), bool()/int()/float() coercion, or an f-string")
register_rule("trace-mutate-capture", "trace",
              "in-place write into a captured tensor, or mutation of a "
              "captured container, inside a traced function")

_TIME_FNS = {"time", "monotonic", "perf_counter", "sleep", "process_time",
             "time_ns", "monotonic_ns", "perf_counter_ns", "clock"}
_MUTATORS = {"append", "extend", "insert", "remove", "pop", "popitem",
             "clear", "update", "setdefault", "add", "discard", "sort",
             "reverse", "write"}
_HOST_ESCAPES = {"item", "tolist", "numpy"}


class _Imports:
    """The module's names for ``time``, ``random``, ``numpy`` and ``os``,
    and its from-imports."""

    def __init__(self, tree: ast.Module):
        self.time: Set[str] = set()
        self.random: Set[str] = set()
        self.numpy: Set[str] = set()
        self.os: Set[str] = set()
        self.modules: Set[str] = set()
        self.from_imports: Dict[str, Tuple[str, str]] = {}
        for node in walk_nodes(tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    local = a.asname or a.name.split(".")[0]
                    root = a.name.split(".")[0]
                    self.modules.add(local)
                    {"time": self.time, "random": self.random,
                     "numpy": self.numpy, "os": self.os}.get(
                        root, set()).add(local)
            elif isinstance(node, ast.ImportFrom):
                mod = node.module or ""
                for a in node.names:
                    self.from_imports[a.asname or a.name] = (mod, a.name)
                    self.modules.add(a.asname or a.name)


def _locals_of(node) -> Set[str]:
    """Parameters and every name a function binds."""
    out: Set[str] = set(dfmod._params(node)) if not isinstance(
        node, ast.Lambda) else {a.arg for a in node.args.args}
    a = node.args
    if a.vararg:
        out.add(a.vararg.arg)
    if a.kwarg:
        out.add(a.kwarg.arg)

    def add(t) -> None:
        for n in ast.walk(t):
            if isinstance(n, ast.Name):
                out.add(n.id)

    for n in walk_nodes(node):
        if isinstance(n, ast.Assign):
            for t in n.targets:
                if isinstance(t, (ast.Name, ast.Tuple, ast.List,
                                  ast.Starred)):
                    add(t)
        elif isinstance(n, (ast.AugAssign, ast.AnnAssign)):
            if isinstance(n.target, ast.Name):
                out.add(n.target.id)
        elif isinstance(n, (ast.For, ast.comprehension)):
            add(n.target)
        elif isinstance(n, ast.withitem) and n.optional_vars is not None:
            add(n.optional_vars)
        elif isinstance(n, ast.NamedExpr):
            add(n.target)
        elif isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.add(n.name)
        elif isinstance(n, (ast.Import, ast.ImportFrom)):
            for al in n.names:
                out.add(al.asname or al.name.split(".")[0])
    return out


def _tensor_guard(test) -> Optional[bool]:
    """True for ``isinstance(x, torch.Tensor)``, False for its negation,
    None for any other test."""
    if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
        inner = _tensor_guard(test.operand)
        return None if inner is None else not inner
    if isinstance(test, ast.Call) and isinstance(test.func, ast.Name) \
            and test.func.id == "isinstance" and len(test.args) == 2:
        kinds = test.args[1].elts if isinstance(
            test.args[1], ast.Tuple) else [test.args[1]]
        if any(dfmod._leaf(k) == "Tensor" for k in kinds):
            return True
    return None


def _traced_nodes(fn_node) -> List[ast.AST]:
    """The function's own nodes, less nested defs and less the scalar
    branch of an ``isinstance(x, torch.Tensor)`` test."""
    out: List[ast.AST] = []
    stack = list(ast.iter_child_nodes(fn_node))
    while stack:
        n = stack.pop()
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.Lambda, ast.ClassDef)):
            continue
        out.append(n)
        if isinstance(n, (ast.If, ast.IfExp)):
            g = _tensor_guard(n.test)
            if g is not None:
                stack.append(n.test)
                taken = n.body if g else n.orelse
                stack.extend(taken if isinstance(taken, list) else [taken])
                continue
        stack.extend(ast.iter_child_nodes(n))
    return out


def _ancestors(cg: cgmod.CallGraph, fi: cgmod.FuncInfo
               ) -> List[cgmod.FuncInfo]:
    out = []
    qual = fi.qualname
    while ".<locals>." in qual or (qual.endswith(".<lambda>")
                                   and "." in qual):
        qual = qual.rsplit(".<locals>.", 1)[0] if ".<locals>." in qual \
            else qual.rsplit(".", 1)[0]
        p = cg.funcs.get(f"{fi.module}:{qual}")
        if p is not None:
            out.append(p)
    return out


def check_project(mods: Sequence[ModuleSource],
                  cg: Optional[cgmod.CallGraph] = None,
                  df: Optional[dfmod.DeviceDataflow] = None,
                  seen: Optional[Dict[str, int]] = None
                  ) -> List[Tuple[Optional[str], Finding]]:
    if df is None:
        df = dfmod.build(mods, cg)
    if seen is None:
        seen = {}
    cg = df.cg
    bymod = {m.relpath: m for m in mods}
    imports: Dict[str, _Imports] = {}
    out: List[Tuple[Optional[str], Finding]] = []
    seen["trace_sites"] = len(df.sites)
    seen["trace_bodies"] = sum(
        1 for s in df.sites for k in s.body_keys
        if not isinstance(cg.funcs[k].node, ast.Lambda))
    seen["trace_functions"] = len(df.traced)
    for key in sorted(df.traced):
        fi = cg.funcs.get(key)
        mod = bymod.get(fi.relpath) if fi is not None else None
        if mod is None:
            continue
        imp = imports.get(fi.relpath)
        if imp is None:
            imp = imports[fi.relpath] = _Imports(mod.tree)
        bat = df.batched_names(key)
        local = _locals_of(fi.node)
        for a in _ancestors(cg, fi):
            local |= _locals_of(a.node)
        # parameters a partial bound before the transform are captured
        captured_params = set()
        if any(key in s.body_keys for s in df.sites) \
                and not isinstance(fi.node, ast.Lambda):
            captured_params = set(dfmod._params(fi.node)) - bat
        raise_fmt = {id(n) for r in walk_nodes(fi.node)
                     if isinstance(r, ast.Raise) for n in ast.walk(r)}

        def emit(rule: str, node, msg: str) -> None:
            out.append((fi.relpath, Finding(
                rule=rule, path=fi.relpath,
                line=getattr(node, "lineno", fi.lineno),
                message=f"{fi.qualname}: {msg}",
                context=f"{fi.qualname}:{msg}")))

        def captured(name: Optional[str]) -> bool:
            return name is not None and name not in imp.modules and (
                name in captured_params or name not in local)

        for node in _traced_nodes(fi.node):
            if isinstance(node, ast.Call):
                _check_call(node, imp, bat, captured, emit)
            elif isinstance(node, (ast.Assign, ast.AugAssign)):
                targets = node.targets if isinstance(node, ast.Assign) \
                    else [node.target]
                for t in targets:
                    if isinstance(t, ast.Subscript) \
                            and captured(dfmod.root_name(t)):
                        emit("trace-mutate-capture", node,
                             f"subscript assignment writes into captured "
                             f"{dfmod.root_name(t)!r}")
            elif isinstance(node, ast.Global) and node.names:
                emit("trace-mutate-capture", node,
                     f"global mutation of {', '.join(node.names)} inside "
                     f"a traced function")
            elif isinstance(node, ast.FormattedValue):
                v = node.value
                if id(node) not in raise_fmt and isinstance(v, ast.Name) \
                        and v.id in bat:
                    emit("trace-tracer-leak", node,
                         f"batched value {v.id!r} formatted into an "
                         f"f-string")
    return out


def _check_call(node: ast.Call, imp: _Imports, bat: Set[str], captured,
                emit) -> None:
    f = node.func
    dotted = dfmod._dotted(f)
    parts = dotted.split(".") if dotted else []
    base, leaf = (parts[0], parts[-1]) if parts else (None, dfmod._leaf(f))
    if dotted in ("print", "input", "open"):
        emit("trace-side-effect", node,
             f"{dotted}() inside a traced function")
        return
    if base in imp.time and len(parts) == 2 and leaf in _TIME_FNS:
        emit("trace-side-effect", node,
             f"{dotted}() reads the host clock inside a traced function")
        return
    if base in imp.random and len(parts) >= 2:
        emit("trace-side-effect", node,
             f"stdlib random ({dotted}) inside a traced function — use "
             f"torch's RNG with an explicit generator")
        return
    if base in imp.numpy and len(parts) >= 3 and parts[1] == "random":
        emit("trace-side-effect", node,
             f"numpy RNG ({dotted}) inside a traced function — use "
             f"torch's RNG with an explicit generator")
        return
    if base in imp.os and leaf == "urandom":
        emit("trace-side-effect", node,
             f"{dotted}() inside a traced function")
        return
    src = imp.from_imports.get(dotted or "")
    if src is not None:
        if src[0] == "time" and src[1] in _TIME_FNS:
            emit("trace-side-effect", node,
                 f"{src[1]}() (from time) reads the host clock inside a "
                 f"traced function")
            return
        if src[0] == "random":
            emit("trace-side-effect", node,
                 f"{src[1]}() (from random) inside a traced function")
            return
    if dotted in ("bool", "int", "float") and len(node.args) == 1 \
            and any(isinstance(n, ast.Name) and n.id in bat
                    for n in ast.walk(node.args[0])):
        emit("trace-tracer-leak", node,
             f"{dotted}() coerces a batched value "
             f"({ast.unparse(node.args[0])[:40]!r}) to a host value")
        return
    if isinstance(f, ast.Attribute) and f.attr in _HOST_ESCAPES \
            and not node.args:
        emit("trace-tracer-leak", node,
             f".{f.attr}() pulls a tensor to the host inside a traced "
             f"function")
        return
    if isinstance(f, ast.Attribute):
        r = dfmod.root_name(f.value)
        if f.attr in _MUTATORS and isinstance(f.value, ast.Name) \
                and captured(r):
            emit("trace-mutate-capture", node,
                 f"{r}.{f.attr}() mutates a captured container")
        elif f.attr.endswith("_") and not f.attr.startswith("_") \
                and captured(r):
            emit("trace-mutate-capture", node,
                 f"{r}...{f.attr}() writes in place into captured "
                 f"{r!r}")
