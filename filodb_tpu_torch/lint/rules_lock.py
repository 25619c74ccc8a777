"""Lock-discipline rules.

Driven by :func:`filodb_tpu_torch.lint.locks.guarded_by` class decorators
(and module-level ``__guarded_by__`` dicts for module-global state):

  * ``lock-guarded-access`` — a guarded field is read or written
    outside a ``with <owner>.<lock>:`` block. ``self.<field>`` is
    checked inside the declaring class (``__init__`` and ``*_locked``
    methods exempt — construction happens-before publication, and the
    ``_locked`` suffix is the caller-holds-the-lock convention);
    ``other.<field>`` is checked package-wide for underscore-prefixed
    guarded fields (public counters may be read racily on purpose —
    pragma those reads).
  * ``lock-blocking-call`` — a blocking call (sleep, socket dial,
    urlopen/requests, subprocess, future ``.result()``) made while any
    declared lock is held: the classic way one slow peer stalls every
    thread behind the lock.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, Iterable, List, Optional, Set, Tuple

from filodb_tpu_torch.lint import Finding, ModuleSource, register_rule

register_rule("lock-guarded-access", "lock",
              "guarded field accessed outside its declared lock")
from filodb_tpu_torch.lint.astwalk import walk_nodes
register_rule("lock-blocking-call", "lock",
              "blocking call made while holding a lock")

_BLOCKING_LEAVES = {"sleep", "urlopen", "create_connection", "getaddrinfo",
                    "result", "system", "check_output", "check_call",
                    "run_until_complete"}
_BLOCKING_BASES = {"requests", "subprocess"}

Held = FrozenSet[Tuple[str, str]]       # (owner name or "", lock attr)


@dataclass
class LockDecls:
    """Package-wide declaration tables."""
    # (relpath, class name) -> {field: lock}
    by_class: Dict[Tuple[str, str], Dict[str, str]] = field(
        default_factory=dict)
    # underscore field -> possible locks (foreign-object checks)
    foreign: Dict[str, Set[str]] = field(default_factory=dict)
    # relpath -> {global name: lock name}
    by_module: Dict[str, Dict[str, str]] = field(default_factory=dict)


def _guarded_by_decl(d: ast.expr) -> Optional[Tuple[str, List[str]]]:
    if not isinstance(d, ast.Call):
        return None
    target = d.func
    name = target.attr if isinstance(target, ast.Attribute) else \
        target.id if isinstance(target, ast.Name) else None
    if name != "guarded_by" or not d.args:
        return None
    vals = [a.value for a in d.args
            if isinstance(a, ast.Constant) and isinstance(a.value, str)]
    if len(vals) != len(d.args) or len(vals) < 2:
        return None
    return vals[0], vals[1:]


def collect_declarations(mods: Iterable[ModuleSource]) -> LockDecls:
    decls = LockDecls()
    for mod in mods:
        for node in walk_nodes(mod.tree):
            if isinstance(node, ast.ClassDef):
                fields: Dict[str, str] = {}
                for d in node.decorator_list:
                    got = _guarded_by_decl(d)
                    if got is None:
                        continue
                    lock, names = got
                    for f in names:
                        fields[f] = lock
                if fields:
                    decls.by_class[(mod.relpath, node.name)] = fields
                    for f, lock in fields.items():
                        if f.startswith("_"):
                            decls.foreign.setdefault(f, set()).add(lock)
            elif isinstance(node, ast.Assign):
                for t in node.targets:
                    if isinstance(t, ast.Name) \
                            and t.id == "__guarded_by__" \
                            and isinstance(node.value, ast.Dict):
                        table: Dict[str, str] = {}
                        for k, v in zip(node.value.keys,
                                        node.value.values):
                            if isinstance(k, ast.Constant) \
                                    and isinstance(v, ast.Constant):
                                table[str(k.value)] = str(v.value)
                        if table:
                            decls.by_module.setdefault(
                                mod.relpath, {}).update(table)
    return decls


def _with_locks(node: ast.With) -> Set[Tuple[str, str]]:
    out: Set[Tuple[str, str]] = set()
    for item in node.items:
        e = item.context_expr
        if isinstance(e, ast.Attribute) and isinstance(e.value, ast.Name):
            out.add((e.value.id, e.attr))
        elif isinstance(e, ast.Name):
            out.add(("", e.id))
    return out


def _exempt(fn_name: str) -> bool:
    return fn_name == "__init__" or fn_name.endswith("_locked")


class _MethodChecker:
    """Walk one function body tracking held locks lexically."""

    def __init__(self, mod: ModuleSource, qualname: str,
                 self_fields: Dict[str, str],
                 foreign: Dict[str, Set[str]],
                 globals_: Dict[str, str],
                 findings: List[Finding]) -> None:
        self.mod = mod
        self.qualname = qualname
        self.self_fields = self_fields
        self.foreign = foreign
        self.globals_ = globals_
        self.findings = findings

    def emit(self, rule: str, node: ast.AST, msg: str) -> None:
        self.findings.append(Finding(
            rule=rule, path=self.mod.relpath,
            line=getattr(node, "lineno", 1), message=msg,
            context=f"{self.qualname}:{msg}"))

    def walk(self, node: ast.AST, held: Held) -> None:
        if isinstance(node, ast.With):
            inner = frozenset(held | _with_locks(node))
            for item in node.items:
                self.walk(item.context_expr, held)
            for child in node.body:
                self.walk(child, inner)
            return
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # nested defs (callbacks) don't inherit the lexical lock:
            # they may run later, off-thread
            for child in ast.iter_child_nodes(node):
                self.walk(child, frozenset())
            return
        self.check(node, held)
        for child in ast.iter_child_nodes(node):
            self.walk(child, held)

    def check(self, node: ast.AST, held: Held) -> None:
        if isinstance(node, ast.Attribute) \
                and isinstance(node.value, ast.Name):
            owner, attr = node.value.id, node.attr
            if owner == "self" and attr in self.self_fields:
                lock = self.self_fields[attr]
                if ("self", lock) not in held:
                    self.emit("lock-guarded-access", node,
                              f"self.{attr} accessed without "
                              f"`with self.{lock}:`")
            elif owner != "self" and attr in self.foreign \
                    and attr.startswith("_"):
                locks = self.foreign[attr]
                if not any((owner, lk) in held for lk in locks):
                    want = "/".join(sorted(locks))
                    self.emit("lock-guarded-access", node,
                              f"{owner}.{attr} accessed without "
                              f"`with {owner}.{want}:`")
        elif isinstance(node, ast.Name) and node.id in self.globals_:
            lock = self.globals_[node.id]
            if ("", lock) not in held:
                self.emit("lock-guarded-access", node,
                          f"module global {node.id} accessed without "
                          f"`with {lock}:`")
        if held and isinstance(node, ast.Call):
            self.check_blocking(node, held)

    def check_blocking(self, node: ast.Call, held: Held) -> None:
        f = node.func
        leaf = f.attr if isinstance(f, ast.Attribute) else \
            f.id if isinstance(f, ast.Name) else None
        if leaf is None:
            return
        base = None
        if isinstance(f, ast.Attribute):
            b = f.value
            while isinstance(b, ast.Attribute):
                b = b.value
            if isinstance(b, ast.Name):
                base = b.id
        blocking = (leaf in _BLOCKING_LEAVES
                    or (base in _BLOCKING_BASES)
                    or (base == "socket"))
        if blocking:
            locks = ", ".join(
                f"{o + '.' if o else ''}{lk}" for o, lk in sorted(held))
            name = leaf if base is None else f"{base}...{leaf}"
            self.emit("lock-blocking-call", node,
                      f"blocking call {name}() while holding {locks}")


def check_module(mod: ModuleSource, decls: LockDecls
                 ) -> Iterable[Finding]:
    findings: List[Finding] = []
    globals_ = decls.by_module.get(mod.relpath, {})
    for node in mod.tree.body:
        if isinstance(node, ast.ClassDef):
            fields = decls.by_class.get((mod.relpath, node.name), {})
            for item in node.body:
                if not isinstance(item, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)):
                    continue
                if _exempt(item.name):
                    continue
                chk = _MethodChecker(
                    mod, f"{node.name}.{item.name}", fields,
                    decls.foreign, globals_, findings)
                for child in item.body:
                    chk.walk(child, frozenset())
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if _exempt(node.name):
                continue
            chk = _MethodChecker(mod, node.name, {}, decls.foreign,
                                 globals_, findings)
            for child in node.body:
                chk.walk(child, frozenset())
    return findings
