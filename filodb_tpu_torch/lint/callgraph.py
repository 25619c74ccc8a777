"""Whole-program call graph + interprocedural lock analysis.

The lock rules (``rules_lock``) see one function body at a time; two
bugs of the reference system they could not catch (the
``_merge_cache`` race, the abort-vs-driver-start registration gate)
lived across *call chains* and *lock pairs*. This
module is the engine under graftlint's concurrency families
(``rules_concurrency``): it builds a project call graph over the parsed
:class:`~filodb_tpu_torch.lint.ModuleSource` set and computes, statically:

  * **definitions** — every function, method, nested closure, and
    lambda, keyed by a module-qualified name (``pkg.mod:Cls.meth``);
  * **edges** — call sites resolved by lexical scope, import tables,
    ``self.``-method dispatch, constructor-typed locals/attributes
    (``self._q = queue.Queue()`` makes ``self._q.get()`` a Queue.get),
    and a unique-method fallback (an attribute call resolves to a class
    method only when exactly one class in the project defines it).
    Edges are kinded: ``call`` (same thread, held locks flow through),
    ``thread`` (``threading.Thread(target=...)`` / executor
    ``.submit(fn)`` — a NEW thread root, empty held set), ``callback``
    (a function reference passed as an argument — may run later on
    another thread: reachability flows, held locks do not);
  * **lock behavior** — per function: canonical locks acquired (and
    what was already held), calls and blocking primitives with the
    lexically-held set at each site, compound mutations of shared
    attributes/globals;
  * **propagation** — ``may_held`` (union over callers: which locks can
    be held on entry — feeds the acquisition-order graph and the
    deep blocking rule), ``must_held`` (intersection over reachable
    callers: which locks are *always* held on entry — feeds the
    unguarded-shared-state guard check), per-thread-root forward
    reachability, and a transitive ``blocks`` summary (the nearest
    blocking primitive reachable from each function, with one example
    call chain for the report).

Canonical lock names: ``Cls.attr`` for instance locks (all instances
of a class share one order node — the standard lock-order abstraction),
``pkg.mod:name`` for module globals. A ``with`` on an attribute whose
owner cannot be typed canonicalizes to ``?.attr``: it still counts as
"a lock is held" for the blocking rule but is excluded from the order
graph (an unknown owner would alias unrelated locks into false cycles).

Everything here is pure AST work — nothing is imported or executed.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, Iterable, List, Optional, Sequence, Set, Tuple

from filodb_tpu_torch.lint import ModuleSource

# builtin constructor types we track for blocking-primitive typing
from filodb_tpu_torch.lint.astwalk import walk_nodes
_BUILTIN_TYPES = {
    ("threading", "Lock"): "threading.Lock",
    ("threading", "RLock"): "threading.RLock",
    ("threading", "Condition"): "threading.Condition",
    ("threading", "Event"): "threading.Event",
    ("threading", "Semaphore"): "threading.Semaphore",
    ("threading", "BoundedSemaphore"): "threading.Semaphore",
    ("threading", "Thread"): "threading.Thread",
    ("queue", "Queue"): "queue.Queue",
    ("queue", "SimpleQueue"): "queue.Queue",
}

_LOCK_TYPES = {"threading.Lock", "threading.RLock", "threading.Semaphore"}

# method names that mutate their receiver in place (compound — not the
# GIL-atomic single-rebind publish idiom)
_MUTATOR_METHODS = {
    "append", "extend", "insert", "remove", "pop", "popitem", "clear",
    "add", "discard", "update", "setdefault", "appendleft", "popleft",
}

# blocking primitives by call-leaf name (unconditional)
_BLOCKING_LEAVES = {
    "sleep": "time.sleep",
    "urlopen": "urllib.urlopen",
    "create_connection": "socket dial",
    "getaddrinfo": "DNS resolve",
    "fsync": "os.fsync",
    "result": "Future.result",
    "block_until_ready": "device sync",
    "device_get": "device sync",
    "check_output": "subprocess",
    "check_call": "subprocess",
    "run_until_complete": "event loop",
}
_BLOCKING_BASES = {"requests": "HTTP fetch", "subprocess": "subprocess",
                   "socket": "socket op"}

# project functions that ARE blocking primitives even though their body
# hides the wait behind an abstraction the leaf table can't see
# (qualified by "Cls.name" or bare function name)
BLOCKING_QUALNAMES = {
    "SplitResult.get": "device sync (per-batch device->host copy)",
}

_SPAWN_LEAVES = {"submit", "run_in_executor", "start_new_thread",
                 "call_soon_threadsafe", "apply_async"}


def module_dotted(relpath: str) -> str:
    p = relpath[:-3] if relpath.endswith(".py") else relpath
    return p.replace("/", ".")


@dataclass
class CallSite:
    """One resolved call inside a function body."""
    line: int
    held: FrozenSet[str]            # canonical locks lexically held
    callees: Tuple[str, ...]        # FuncInfo keys (may be empty)
    kind: str                       # call | thread | callback
    blocking: Optional[str] = None  # blocking-primitive label, if any
    label: str = ""                 # source-ish name for messages


@dataclass
class Acquisition:
    lock: str                       # canonical name
    line: int
    held: FrozenSet[str]            # locks lexically held at acquisition


@dataclass
class Mutation:
    """A compound mutation of shared state (attr or module global)."""
    target: str                     # "Cls.attr" or "pkg.mod:name"
    line: int
    held: FrozenSet[str]
    detail: str                     # e.g. "drivers.pop(...)"


@dataclass
class FuncInfo:
    key: str                        # "pkg.mod:Qual.Name" — unique id
    relpath: str
    module: str
    cls: Optional[str]
    name: str
    qualname: str                   # Cls.meth / outer.<locals>.inner
    node: ast.AST
    lineno: int
    thread_root: Optional[str] = None   # @thread_root name, if marked
    sites: List[CallSite] = field(default_factory=list)
    acquisitions: List[Acquisition] = field(default_factory=list)
    mutations: List[Mutation] = field(default_factory=list)


@dataclass
class ClassInfo:
    name: str
    relpath: str
    module: str
    node: ast.ClassDef
    methods: Dict[str, FuncInfo] = field(default_factory=dict)
    attr_types: Dict[str, str] = field(default_factory=dict)
    guarded: Dict[str, str] = field(default_factory=dict)  # field -> lock
    single_writer: Optional[str] = None     # @single_writer reason


def _decorator_names(node) -> List[str]:
    out = []
    for d in getattr(node, "decorator_list", ()):
        t = d.func if isinstance(d, ast.Call) else d
        if isinstance(t, ast.Attribute):
            out.append(t.attr)
        elif isinstance(t, ast.Name):
            out.append(t.id)
    return out


def _thread_root_name(node) -> Optional[str]:
    """The @thread_root marker (bare or called with a name)."""
    for d in getattr(node, "decorator_list", ()):
        t = d.func if isinstance(d, ast.Call) else d
        leaf = t.attr if isinstance(t, ast.Attribute) else \
            t.id if isinstance(t, ast.Name) else None
        if leaf == "thread_root":
            if isinstance(d, ast.Call):
                for a in d.args:
                    if isinstance(a, ast.Constant) \
                            and isinstance(a.value, str):
                        return a.value
            return getattr(node, "name", "<root>")
    return None


class CallGraph:
    """The project-wide graph plus the propagation results."""

    def __init__(self, mods: Sequence[ModuleSource]):
        self.mods = list(mods)
        self.funcs: Dict[str, FuncInfo] = {}
        self.classes: Dict[str, ClassInfo] = {}        # by class name
        self._classes_by_mod: Dict[Tuple[str, str], ClassInfo] = {}
        # method name -> [class names defining it] (unique-name fallback)
        self._method_owners: Dict[str, List[str]] = {}
        # module dotted -> {local name -> ("mod", dotted) | ("func", key)
        #                   | ("class", class name)}
        self._scopes: Dict[str, Dict[str, Tuple[str, str]]] = {}
        # module dotted -> {global name -> type}
        self._global_types: Dict[str, Dict[str, str]] = {}
        # module dotted -> set of module-level mutable-global names
        self._module_globals: Dict[str, Set[str]] = {}
        self._module_guarded: Dict[str, Dict[str, str]] = {}
        self._index()
        self._analyze_bodies()
        # propagation products (computed lazily via compute())
        self.may_held: Dict[str, FrozenSet[str]] = {}
        self.must_held: Dict[str, FrozenSet[str]] = {}
        # func key -> (caller key, line, lock) provenance for may_held
        self.held_via: Dict[Tuple[str, str], Tuple[str, int]] = {}
        self.blocks: Dict[str, Tuple[str, Tuple[Tuple[str, int], ...]]] = {}
        self.roots: Dict[str, str] = {}     # func key -> root kind/name
        self.reachable_from: Dict[str, Set[str]] = {}
        self.compute()

    # -- pass 1: definitions, imports, types -------------------------------

    def _index(self) -> None:
        for mod in self.mods:
            dotted = module_dotted(mod.relpath)
            scope: Dict[str, Tuple[str, str]] = {}
            self._scopes[dotted] = scope
            self._global_types.setdefault(dotted, {})
            self._module_globals.setdefault(dotted, set())
            for node in mod.tree.body:
                if isinstance(node, (ast.Import, ast.ImportFrom)):
                    self._index_import(node, scope)
            for node in mod.tree.body:
                if isinstance(node, ast.ClassDef):
                    self._index_class(mod, dotted, node, scope)
                elif isinstance(node, (ast.FunctionDef,
                                       ast.AsyncFunctionDef)):
                    self._index_func(mod, dotted, node, None, node.name,
                                     scope)
                elif isinstance(node, ast.Assign):
                    self._index_module_assign(mod, dotted, node)
        # attribute typing runs after EVERY class is indexed, so
        # annotations/constructors referencing later-defined classes
        # still resolve
        for ci in self._classes_by_mod.values():
            self._type_class_attrs(ci)

    def _index_import(self, node, scope) -> None:
        if isinstance(node, ast.Import):
            for alias in node.names:
                name = alias.asname or alias.name.split(".")[0]
                scope[name] = ("mod", alias.name if alias.asname
                               else alias.name.split(".")[0])
        else:
            if node.module is None or node.level:
                return
            for alias in node.names:
                name = alias.asname or alias.name
                scope[name] = ("import_from", f"{node.module}:{alias.name}")

    def _index_module_assign(self, mod, dotted, node: ast.Assign) -> None:
        for t in node.targets:
            if not isinstance(t, ast.Name):
                continue
            if t.id == "__guarded_by__" and isinstance(node.value, ast.Dict):
                table = {}
                for k, v in zip(node.value.keys, node.value.values):
                    if isinstance(k, ast.Constant) \
                            and isinstance(v, ast.Constant):
                        table[str(k.value)] = str(v.value)
                self._module_guarded.setdefault(dotted, {}).update(table)
                continue
            ty = self._expr_type_static(node.value, dotted)
            if ty:
                self._global_types[dotted][t.id] = ty
            if isinstance(node.value, (ast.Dict, ast.List, ast.Set,
                                       ast.DictComp, ast.ListComp,
                                       ast.Call)):
                self._module_globals[dotted].add(t.id)

    def _index_class(self, mod, dotted, node: ast.ClassDef, scope) -> None:
        ci = ClassInfo(name=node.name, relpath=mod.relpath, module=dotted,
                       node=node)
        # @guarded_by / @single_writer declarations (rules_lock
        # semantics shared with filodb_tpu_torch.lint.locks)
        for d in node.decorator_list:
            if isinstance(d, ast.Call):
                t = d.func
                leaf = t.attr if isinstance(t, ast.Attribute) else \
                    t.id if isinstance(t, ast.Name) else None
                vals = [a.value for a in d.args
                        if isinstance(a, ast.Constant)
                        and isinstance(a.value, str)]
                if leaf == "guarded_by" and len(vals) >= 2:
                    for f in vals[1:]:
                        ci.guarded[f] = vals[0]
                elif leaf == "single_writer" and vals:
                    ci.single_writer = vals[0]
        self._classes_by_mod[(dotted, node.name)] = ci
        # first definition wins for the by-name map; ambiguity recorded
        self.classes.setdefault(node.name, ci)
        scope.setdefault(node.name, ("class", node.name))
        for item in node.body:
            if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                fi = self._index_func(mod, dotted, item, node.name,
                                      f"{node.name}.{item.name}", scope)
                ci.methods[item.name] = fi
                self._method_owners.setdefault(item.name, []).append(
                    node.name)
    def _type_class_attrs(self, ci: ClassInfo) -> None:
        """Attribute types from every method's `self.x = T(...)` and
        `self.x = param` where the parameter annotation names a class."""
        for item in ci.node.body:
            if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                params = {a.arg: self._annotation_type(a.annotation)
                          for a in item.args.args if a.annotation}
                for sub in walk_nodes(item):
                    if isinstance(sub, ast.Assign) and len(sub.targets) == 1:
                        t = sub.targets[0]
                        if isinstance(t, ast.Attribute) \
                                and isinstance(t.value, ast.Name) \
                                and t.value.id == "self":
                            ty = self._expr_type_static(sub.value,
                                                        ci.module)
                            if ty is None and isinstance(sub.value,
                                                         ast.Name):
                                ty = params.get(sub.value.id)
                            if ty:
                                ci.attr_types.setdefault(t.attr, ty)

    def _annotation_type(self, ann) -> Optional[str]:
        """A parameter annotation that names a project class (bare or
        string-quoted), else None."""
        if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
            name = ann.value.strip().strip("'\"")
        elif isinstance(ann, ast.Name):
            name = ann.id
        elif isinstance(ann, ast.Attribute):
            name = ann.attr
        else:
            return None
        return name if name in self.classes else None

    def _index_func(self, mod, dotted, node, cls: Optional[str],
                    qualname: str, scope) -> FuncInfo:
        key = f"{dotted}:{qualname}"
        fi = FuncInfo(key=key, relpath=mod.relpath, module=dotted,
                      cls=cls, name=getattr(node, "name", "<lambda>"),
                      qualname=qualname, node=node, lineno=node.lineno,
                      thread_root=_thread_root_name(node))
        self.funcs[key] = fi
        if cls is None:
            scope.setdefault(getattr(node, "name", qualname),
                             ("func", key))
        # nested defs (closures) — indexed so thread targets resolve
        for item in ast.iter_child_nodes(node):
            self._index_nested(mod, dotted, item, cls, qualname)
        return fi

    def _index_nested(self, mod, dotted, node, cls, parent_qual) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            self._index_func(
                mod, dotted, node, cls,
                f"{parent_qual}.<locals>.{node.name}", self._scopes[dotted])
            return
        for item in ast.iter_child_nodes(node):
            self._index_nested(mod, dotted, item, cls, parent_qual)

    def _expr_type_static(self, expr, dotted) -> Optional[str]:
        """Type of a constructor-ish expression, or None."""
        if isinstance(expr, ast.BoolOp):
            for v in expr.values:
                ty = self._expr_type_static(v, dotted)
                if ty:
                    return ty
            return None
        if isinstance(expr, ast.IfExp):
            return (self._expr_type_static(expr.body, dotted)
                    or self._expr_type_static(expr.orelse, dotted))
        if not isinstance(expr, ast.Call):
            return None
        f = expr.func
        if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name):
            ty = _BUILTIN_TYPES.get((f.value.id, f.attr))
            if ty:
                return ty
            return f.attr if f.attr in self.classes else None
        if isinstance(f, ast.Name):
            if f.id in self.classes:
                return f.id
            ent = self._scopes.get(dotted, {}).get(f.id)
            if ent and ent[0] == "import_from":
                leaf = ent[1].split(":")[1]
                ty = _BUILTIN_TYPES.get(tuple(ent[1].split(":")))
                if ty:
                    return ty
                if leaf in self.classes:
                    return leaf
        return None

    # -- pass 2: per-function lexical analysis ------------------------------

    def _analyze_bodies(self) -> None:
        for fi in list(self.funcs.values()):
            _BodyWalker(self, fi).run()

    # -- resolution helpers -------------------------------------------------

    def class_of(self, name: str) -> Optional[ClassInfo]:
        return self.classes.get(name)

    def resolve_method(self, cls_name: str, meth: str) -> Optional[str]:
        ci = self.classes.get(cls_name)
        if ci and meth in ci.methods:
            return ci.methods[meth].key
        # one level of bases by name
        if ci:
            for b in ci.node.bases:
                bn = b.id if isinstance(b, ast.Name) else \
                    b.attr if isinstance(b, ast.Attribute) else None
                if bn and bn != cls_name:
                    bi = self.classes.get(bn)
                    if bi and meth in bi.methods:
                        return bi.methods[meth].key
        return None

    def unique_method(self, meth: str) -> Optional[str]:
        """Last-resort resolution for an attribute call on an untyped
        receiver: the method name must be defined by exactly ONE class
        in the project AND be multi-word/private (``flush_all``,
        ``_adopt_shard``) — generic verbs (``flush``, ``get``,
        ``read``) alias stdlib/file objects into false edges."""
        if "_" not in meth:
            return None
        owners = self._method_owners.get(meth, [])
        if len(owners) == 1:
            return self.resolve_method(owners[0], meth)
        return None

    # -- propagation --------------------------------------------------------

    def compute(self) -> None:
        self._compute_roots()
        self._propagate_may_held()
        self._compute_blocks()
        self._propagate_must_held()
        self._compute_reachability()

    def _compute_roots(self) -> None:
        for fi in self.funcs.values():
            if fi.thread_root is not None:
                self.roots[fi.key] = fi.thread_root
        for fi in self.funcs.values():
            for s in fi.sites:
                if s.kind == "thread":
                    for c in s.callees:
                        self.roots.setdefault(
                            c, self.funcs[c].qualname)
        # module-level __thread_roots__ declarations
        for mod in self.mods:
            dotted = module_dotted(mod.relpath)
            for node in mod.tree.body:
                if isinstance(node, ast.Assign):
                    for t in node.targets:
                        if isinstance(t, ast.Name) \
                                and t.id == "__thread_roots__" \
                                and isinstance(node.value,
                                               (ast.Tuple, ast.List)):
                            for e in node.value.elts:
                                if isinstance(e, ast.Constant):
                                    k = f"{dotted}:{e.value}"
                                    if k in self.funcs:
                                        self.roots.setdefault(
                                            k, str(e.value))

    def _propagate_may_held(self) -> None:
        """may_held(g) = union over call edges f->g of
        (may_held(f) | lexical held at the site). Thread/callback edges
        reset to empty (a new thread holds nothing of its spawner)."""
        may: Dict[str, Set[str]] = {k: set() for k in self.funcs}
        work = list(self.funcs.keys())
        while work:
            fkey = work.pop()
            fi = self.funcs[fkey]
            base = may[fkey]
            for s in fi.sites:
                if s.kind != "call":
                    continue
                incoming = base | set(s.held)
                if not incoming:
                    continue
                for c in s.callees:
                    if c not in may:
                        continue
                    new = incoming - may[c]
                    if new:
                        may[c] |= new
                        for lk in new:
                            self.held_via.setdefault(
                                (c, lk), (fkey, s.line))
                        work.append(c)
        self.may_held = {k: frozenset(v) for k, v in may.items()}

    def _compute_blocks(self) -> None:
        """blocks(f): a blocking-primitive label reachable from f via
        same-thread call edges, with one example chain
        ((func key, line), ...) ending at the primitive site."""
        blocks: Dict[str, Tuple[str, Tuple[Tuple[str, int], ...]]] = {}
        for fi in self.funcs.values():
            for s in fi.sites:
                if s.blocking and fi.key not in blocks:
                    blocks[fi.key] = (s.blocking, ((fi.key, s.line),))
        changed = True
        while changed:
            changed = False
            for fi in self.funcs.values():
                if fi.key in blocks:
                    continue
                for s in fi.sites:
                    if s.kind != "call":
                        continue
                    for c in s.callees:
                        if c in blocks and c != fi.key:
                            label, chain = blocks[c]
                            if len(chain) < 8:
                                blocks[fi.key] = (
                                    label, ((fi.key, s.line),) + chain)
                                changed = True
                                break
                    if fi.key in blocks:
                        break
        self.blocks = blocks

    def _propagate_must_held(self) -> None:
        """must_held(g) = intersection over root-reachable call edges
        f->g of (must_held(f) | lexical held). Roots and unreached
        functions get the empty set."""
        # collect callers per function, restricted to same-thread edges
        callers: Dict[str, List[Tuple[str, FrozenSet[str]]]] = {}
        for fi in self.funcs.values():
            for s in fi.sites:
                if s.kind != "call":
                    continue
                for c in s.callees:
                    callers.setdefault(c, []).append((fi.key, s.held))
        TOP = None      # lattice top: "all locks"
        must: Dict[str, Optional[FrozenSet[str]]] = \
            {k: TOP for k in self.funcs}
        for r in self.roots:
            must[r] = frozenset()
        changed = True
        iters = 0
        while changed and iters < 50:
            changed = False
            iters += 1
            for g in self.funcs:
                acc: Optional[FrozenSet[str]] = None
                any_caller = False
                for fkey, held in callers.get(g, ()):  # noqa: B020
                    fm = must.get(fkey)
                    if fm is TOP:
                        continue        # caller itself unreached yet
                    any_caller = True
                    inc = frozenset(fm | held)
                    acc = inc if acc is None else (acc & inc)
                if g in self.roots:
                    acc = frozenset() if acc is None else frozenset()
                    any_caller = True
                if any_caller and acc is not None and must[g] != acc:
                    if must[g] is TOP or acc != must[g]:
                        must[g] = acc
                        changed = True
        self.must_held = {k: (v if v is not None else frozenset())
                          for k, v in must.items()}

    def _compute_reachability(self) -> None:
        """Forward closure per thread root over call+callback edges
        (thread edges start their own root)."""
        succ: Dict[str, Set[str]] = {}
        for fi in self.funcs.values():
            out = succ.setdefault(fi.key, set())
            for s in fi.sites:
                if s.kind in ("call", "callback"):
                    out.update(s.callees)
        for r in self.roots:
            seen = {r}
            stack = [r]
            while stack:
                f = stack.pop()
                for n in succ.get(f, ()):
                    if n not in seen:
                        seen.add(n)
                        stack.append(n)
            self.reachable_from[r] = seen

    # -- queries used by the rules -----------------------------------------

    def guarded_decl(self, target: str) -> Optional[str]:
        """The declared @guarded_by lock for "Cls.attr" / "mod:name"
        targets, if any."""
        if ":" in target:
            dotted, name = target.split(":", 1)
            return self._module_guarded.get(dotted, {}).get(name)
        cls, _, attr = target.partition(".")
        ci = self.classes.get(cls)
        return ci.guarded.get(attr) if ci else None

    def single_writer_decl(self, target: str) -> Optional[str]:
        """The @single_writer reason of the target's owning class, if
        declared (instances owned by one thread at a time by design —
        ownership transfer is a happens-before edge)."""
        if ":" in target:
            return None
        ci = self.classes.get(target.partition(".")[0])
        return ci.single_writer if ci else None

    def order_pairs(self) -> Dict[Tuple[str, str],
                                  Tuple[str, int, Tuple[str, ...]]]:
        """All observed acquisition-order pairs (A then B, A still
        held): {(A, B): (func key, line of B's acquisition, provenance
        chain of how A came to be held)}. Unknown-owner locks (``?.``)
        and self-pairs are excluded — see the module docstring."""
        pairs: Dict[Tuple[str, str],
                    Tuple[str, int, Tuple[str, ...]]] = {}
        for fi in self.funcs.values():
            inherited = self.may_held.get(fi.key, frozenset())
            for acq in fi.acquisitions:
                if acq.lock.startswith("?."):
                    continue
                for h in acq.held | inherited:
                    if h.startswith("?.") or h == acq.lock:
                        continue
                    k = (h, acq.lock)
                    if k not in pairs:
                        chain: Tuple[str, ...] = ()
                        if h not in acq.held:
                            via = self.held_via.get((fi.key, h))
                            if via:
                                chain = (f"{self.funcs[via[0]].qualname} "
                                         f"({via[0].split(':')[0]}:"
                                         f"{via[1]})",)
                        pairs[k] = (fi.key, acq.line, chain)
        return pairs


class _BodyWalker:
    """Lexical walk of one function body: with-lock scopes, call sites,
    blocking primitives, compound mutations. Nested defs are separate
    FuncInfos (they may run later, on another thread) — only their
    *spawn/callback* relationship is recorded here."""

    def __init__(self, cg: CallGraph, fi: FuncInfo):
        self.cg = cg
        self.fi = fi
        self.scope = cg._scopes.get(fi.module, {})
        self.locals: Dict[str, str] = {}        # var -> type name
        ci = cg._classes_by_mod.get((fi.module, fi.cls)) if fi.cls \
            else None
        self.cls_info = ci

    def run(self) -> None:
        node = self.fi.node
        body = node.body if not isinstance(node, ast.Lambda) \
            else [ast.Expr(node.body)]
        # parameter defaults etc. are not walked — call behavior only
        for child in body:
            self._walk(child, frozenset())

    # -- type inference -----------------------------------------------------

    def _expr_type(self, expr) -> Optional[str]:
        if isinstance(expr, ast.Name):
            if expr.id == "self" and self.fi.cls:
                return self.fi.cls
            ty = self.locals.get(expr.id)
            if ty:
                return ty
            g = self.cg._global_types.get(self.fi.module, {})
            if expr.id in g:
                return g[expr.id]
            ent = self.scope.get(expr.id)
            if ent and ent[0] == "class":
                return None     # a class object, not an instance
            return None
        if isinstance(expr, ast.Attribute) \
                and isinstance(expr.value, ast.Name):
            base_ty = self._expr_type(expr.value)
            if base_ty:
                ci = self.cg.classes.get(base_ty)
                if ci:
                    return ci.attr_types.get(expr.attr)
        return self.cg._expr_type_static(expr, self.fi.module)

    # -- canonical lock naming ----------------------------------------------

    def _lock_name(self, e) -> Optional[str]:
        """Canonical name for a with-context expression that looks like
        a lock (non-Call Attribute/Name), else None. Semaphores are
        excluded: an admission gate is *designed* to be held across
        blocking work — it bounds concurrency, it is not a mutex."""
        if isinstance(e, ast.Attribute):
            base = e.value
            if isinstance(base, ast.Name):
                ty = self._expr_type(base)
                if ty:
                    ci = self.cg.classes.get(ty)
                    if ci and ci.attr_types.get(e.attr) \
                            == "threading.Semaphore":
                        return None
                    return f"{ty}.{e.attr}"
                return f"?.{e.attr}"
            if isinstance(base, ast.Attribute) \
                    and isinstance(base.value, ast.Name):
                ty = self._expr_type(base)
                if ty:
                    return f"{ty}.{e.attr}"
                return f"?.{e.attr}"
            return f"?.{e.attr}"
        if isinstance(e, ast.Name):
            if e.id in self.cg._global_types.get(self.fi.module, {}) \
                    or e.id in self.cg._module_globals.get(
                        self.fi.module, set()):
                return f"{self.fi.module}:{e.id}"
            ty = self.locals.get(e.id)
            if ty in _LOCK_TYPES:
                return f"?.{e.id}"
            return None
        return None

    # -- the walk -----------------------------------------------------------

    def _walk(self, node, held: FrozenSet[str]) -> None:
        if isinstance(node, ast.With):
            inner = set(held)
            for item in node.items:
                self._visit_expr(item.context_expr, held)
                lk = self._lock_name(item.context_expr)
                if lk is not None:
                    self.fi.acquisitions.append(
                        Acquisition(lock=lk, line=node.lineno,
                                    held=frozenset(inner)))
                    inner.add(lk)
            for child in node.body:
                self._walk(child, frozenset(inner))
            return
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return      # separate FuncInfo; not this thread's flow
        if isinstance(node, ast.Assign):
            self._visit_assign(node, held)
            for t in node.targets:
                self._visit_expr(t, held, store=True)
            self._visit_expr(node.value, held)
            return
        if isinstance(node, ast.AugAssign):
            self._visit_aug(node, held)
            self._visit_expr(node.value, held)
            return
        if isinstance(node, ast.Delete):
            for t in node.targets:
                self._visit_del(t, held)
            return
        self._visit_expr_or_children(node, held)

    def _visit_expr_or_children(self, node, held) -> None:
        if isinstance(node, ast.expr):
            self._visit_expr(node, held)
            return
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.expr):
                self._visit_expr(child, held)
            else:
                self._walk(child, held)

    def _visit_expr(self, node, held, store: bool = False) -> None:
        if isinstance(node, ast.Call):
            self._visit_call(node, held)
            return
        if isinstance(node, ast.Lambda):
            return      # body belongs to the lambda FuncInfo
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.expr):
                self._visit_expr(child, held)

    # -- mutations ----------------------------------------------------------

    def _shared_target(self, e) -> Optional[str]:
        """Canonical shared-state id for an attribute/global expression:
        "Cls.attr" when the owner types to a project class, "mod:name"
        for module globals."""
        if isinstance(e, ast.Attribute):
            ty = self._expr_type(e.value) if isinstance(
                e.value, (ast.Name, ast.Attribute)) else None
            if ty and ty in self.cg.classes:
                return f"{ty}.{e.attr}"
            return None
        if isinstance(e, ast.Name):
            if e.id in self.cg._module_globals.get(self.fi.module, set()):
                return f"{self.fi.module}:{e.id}"
        return None

    def _note_mutation(self, target: Optional[str], node, held,
                       detail: str) -> None:
        if target is None:
            return
        if self.fi.name == "__init__" or self.fi.name.endswith("_locked"):
            return      # construction / caller-holds-the-lock convention
        self.fi.mutations.append(Mutation(
            target=target, line=getattr(node, "lineno", self.fi.lineno),
            held=held, detail=detail))

    def _visit_assign(self, node: ast.Assign, held) -> None:
        for t in node.targets:
            if isinstance(t, ast.Subscript):
                self._note_mutation(self._shared_target(t.value), node,
                                    held, "subscript store")
            elif isinstance(t, ast.Attribute):
                tgt = self._shared_target(t)
                # plain rebind is the GIL-atomic publish idiom — only a
                # read-modify-write of the SAME field is compound
                if tgt and self._reads_target(node.value, t):
                    self._note_mutation(tgt, node, held,
                                        "read-modify-write rebind")
            elif isinstance(t, ast.Name):
                ty = self._expr_type(node.value)
                if ty:
                    self.locals[t.id] = ty
                if t.id in self.cg._module_globals.get(
                        self.fi.module, set()) \
                        and self._declares_global(t.id):
                    if self._reads_name(node.value, t.id):
                        self._note_mutation(
                            f"{self.fi.module}:{t.id}", node, held,
                            "read-modify-write rebind")

    def _visit_aug(self, node: ast.AugAssign, held) -> None:
        t = node.target
        if isinstance(t, ast.Attribute):
            self._note_mutation(self._shared_target(t), node, held,
                                "augmented assign")
        elif isinstance(t, ast.Subscript):
            self._note_mutation(self._shared_target(t.value), node, held,
                                "augmented subscript")
        elif isinstance(t, ast.Name) and self._declares_global(t.id):
            self._note_mutation(f"{self.fi.module}:{t.id}", node, held,
                                "augmented assign")

    def _visit_del(self, t, held) -> None:
        if isinstance(t, ast.Subscript):
            self._note_mutation(self._shared_target(t.value), t, held,
                                "del item")

    def _declares_global(self, name: str) -> bool:
        for sub in walk_nodes(self.fi.node):
            if isinstance(sub, ast.Global) and name in sub.names:
                return True
        return False

    def _reads_target(self, expr, attr: ast.Attribute) -> bool:
        for sub in ast.walk(expr):
            if isinstance(sub, ast.Attribute) and sub.attr == attr.attr:
                return True
        return False

    def _reads_name(self, expr, name: str) -> bool:
        for sub in ast.walk(expr):
            if isinstance(sub, ast.Name) and sub.id == name:
                return True
        return False

    # -- calls --------------------------------------------------------------

    def _func_ref(self, e) -> Optional[str]:
        """Resolve an expression used as a function VALUE (not called):
        thread targets, submit args, callbacks."""
        if isinstance(e, ast.Lambda):
            key = f"{self.fi.module}:{self.fi.qualname}" \
                  f".<locals>.<lambda@{e.lineno}>"
            if key not in self.cg.funcs:
                fi = FuncInfo(key=key, relpath=self.fi.relpath,
                              module=self.fi.module, cls=self.fi.cls,
                              name="<lambda>",
                              qualname=f"{self.fi.qualname}.<lambda>",
                              node=e, lineno=e.lineno)
                self.cg.funcs[key] = fi
                _BodyWalker(self.cg, fi).run()
            return key
        if isinstance(e, ast.Attribute) and isinstance(e.value, ast.Name):
            ty = self._expr_type(e.value)
            if ty:
                return self.cg.resolve_method(ty, e.attr)
            return None
        if isinstance(e, ast.Attribute) \
                and isinstance(e.value, ast.Attribute) \
                and isinstance(e.value.value, ast.Name):
            # bound-method reference one attribute deeper:
            # `self.result_cache.invalidate` as a callback argument
            ty = self._expr_type(e.value)
            if ty:
                return self.cg.resolve_method(ty, e.attr)
            return None
        if isinstance(e, ast.Name):
            return self._resolve_name_callee(e.id)
        return None

    def _resolve_name_callee(self, name: str) -> Optional[str]:
        # nested def of this function?
        key = f"{self.fi.module}:{self.fi.qualname}.<locals>.{name}"
        if key in self.cg.funcs:
            return key
        # sibling nested def (shared parent scope)
        parent = self.fi.qualname.rsplit(".<locals>.", 1)[0]
        key = f"{self.fi.module}:{parent}.<locals>.{name}"
        if key in self.cg.funcs:
            return key
        # module-level function / import
        ent = self.scope.get(name)
        if ent:
            if ent[0] == "func":
                return ent[1]
            if ent[0] == "class":
                ci = self.cg.classes.get(ent[1])
                if ci and "__init__" in ci.methods:
                    return ci.methods["__init__"].key
                return None
            if ent[0] == "import_from":
                m, leaf = ent[1].split(":", 1)
                k = f"{m}:{leaf}"
                if k in self.cg.funcs:
                    return k
                ci = self.cg._classes_by_mod.get((m, leaf))
                if ci and "__init__" in ci.methods:
                    return ci.methods["__init__"].key
        return None

    def _visit_call(self, node: ast.Call, held) -> None:
        f = node.func
        leaf = f.attr if isinstance(f, ast.Attribute) else \
            f.id if isinstance(f, ast.Name) else None
        callees: List[str] = []
        kind = "call"
        label = leaf or "<call>"
        blocking = None

        base_ty = None
        if isinstance(f, ast.Attribute):
            base_ty = self._expr_type(f.value) \
                if isinstance(f.value, (ast.Name, ast.Attribute)) else None

        # Thread(target=...) spawn
        ctor_ty = self._expr_type(node)
        if ctor_ty == "threading.Thread" or \
                (leaf == "Thread" and ctor_ty is None):
            tgt = None
            for kw in node.keywords:
                if kw.arg == "target":
                    tgt = self._func_ref(kw.value)
            if tgt:
                self.fi.sites.append(CallSite(
                    line=node.lineno, held=held, callees=(tgt,),
                    kind="thread", label="Thread(target=...)"))
            self._visit_args(node, held)
            return

        # executor-style spawn: .submit(fn) etc.
        if leaf in _SPAWN_LEAVES and isinstance(f, ast.Attribute):
            refs = [r for r in (self._func_ref(a) for a in node.args)
                    if r]
            if refs:
                self.fi.sites.append(CallSite(
                    line=node.lineno, held=held, callees=tuple(refs),
                    kind="thread", label=f".{leaf}(fn)"))
            self._visit_args(node, held, skip_refs=True)
            return

        # resolve the callee
        if isinstance(f, ast.Name):
            c = self._resolve_name_callee(f.id)
            if c:
                callees.append(c)
        elif isinstance(f, ast.Attribute):
            base = f.value
            if isinstance(base, ast.Name):
                ent = self.scope.get(base.id)
                if ent and ent[0] == "mod":
                    # alias.func() on an imported project module
                    for m in self.cg._scopes:
                        if m == ent[1] or m.endswith("." + ent[1]):
                            k = f"{m}:{f.attr}"
                            if k in self.cg.funcs:
                                callees.append(k)
                                break
            if not callees and base_ty:
                c = self.cg.resolve_method(base_ty, f.attr)
                if c:
                    callees.append(c)
                    label = f"{base_ty}.{f.attr}"
            if not callees and leaf:
                c = self.cg.unique_method(leaf)
                if c:
                    callees.append(c)

        # blocking primitive?
        blocking = self._blocking_label(node, f, leaf, base_ty, callees)

        self.fi.sites.append(CallSite(
            line=node.lineno, held=held, callees=tuple(callees),
            kind=kind, blocking=blocking, label=label))

        # function references passed as arguments -> callback edges
        cb = []
        for a in list(node.args) + [kw.value for kw in node.keywords]:
            r = self._func_ref(a)
            if r and r not in callees:
                cb.append(r)
        if cb:
            self.fi.sites.append(CallSite(
                line=node.lineno, held=held, callees=tuple(cb),
                kind="callback", label=f"{label}(callback)"))
        self._visit_args(node, held)
        # chained receivers: `threading.Thread(...).start()` — the
        # inner constructor (and its spawn edge) lives in func.value
        if isinstance(f, ast.Attribute) and not isinstance(
                f.value, ast.Name):
            self._visit_expr(f.value, held)

        # receiver mutation: self.attr.append(...) etc. — but NOT when
        # the name resolved to a project method (`mapper.update(...)`
        # is ShardMapper.update, a call edge, not dict.update)
        if leaf in _MUTATOR_METHODS and isinstance(f, ast.Attribute) \
                and not callees:
            self._note_mutation(self._shared_target(f.value), node, held,
                                f"{leaf}(...)")

    def _visit_args(self, node: ast.Call, held,
                    skip_refs: bool = False) -> None:
        for a in list(node.args) + [kw.value for kw in node.keywords]:
            if skip_refs and self._func_ref(a):
                continue
            self._visit_expr(a, held)

    def _blocking_label(self, node, f, leaf, base_ty,
                        callees) -> Optional[str]:
        if leaf is None:
            return None
        # typed primitives first (most precise)
        if base_ty == "queue.Queue" and leaf == "get":
            for kw in node.keywords:
                if kw.arg in ("timeout", "block"):
                    return None     # bounded / non-blocking get
            return "Queue.get (unbounded)"
        if base_ty in ("threading.Event", "threading.Condition") \
                and leaf == "wait":
            for kw in node.keywords:
                if kw.arg == "timeout":
                    return "Event.wait"
            if node.args:
                return "Event.wait"
            return "Event.wait (unbounded)"
        if base_ty == "threading.Thread" and leaf == "join":
            return "Thread.join"
        # project-declared blocking qualnames
        for c in callees:
            q = self.cg.funcs[c].qualname if c in self.cg.funcs else ""
            if q in BLOCKING_QUALNAMES or leaf in BLOCKING_QUALNAMES:
                return BLOCKING_QUALNAMES.get(
                    q, BLOCKING_QUALNAMES.get(leaf))
        if leaf in _BLOCKING_LEAVES:
            return _BLOCKING_LEAVES[leaf]
        base_name = None
        b = f.value if isinstance(f, ast.Attribute) else None
        while isinstance(b, ast.Attribute):
            b = b.value
        if isinstance(b, ast.Name):
            base_name = b.id
        if base_name in _BLOCKING_BASES:
            return _BLOCKING_BASES[base_name]
        return None


def build(mods: Iterable[ModuleSource]) -> CallGraph:
    """Build + propagate the project call graph."""
    return CallGraph(list(mods))
