"""Device-dataflow layer over the project call graph.

The call graph (``callgraph.py``) answers "who calls whom, holding which
locks". This layer adds the value-level facts the cache and residency
families need, still as pure AST work (nothing is imported or executed):

  * **Trace entry points** — every ``torch.func.vmap`` / ``torch.vmap``
    / ``torch.compile`` wrapping site (decorator or call form) and the
    functions reachable from its body (``traced``): code that runs under
    a transform and retains nothing itself.
  * **Device taint** — which values are torch device tensors, retargeted
    from the reference's ``jnp.*`` tables to torch:

      - allocations: ``torch.{zeros,ones,full,empty,as_tensor,tensor,
        arange,...}`` with a ``device=``, ``torch.{*_like,where,cat,
        stack}`` with a device or a device operand, ``.to(device)`` (a
        ``.to`` whose target is not a dtype) and ``.cuda()``;
      - derivations: views, slices, arithmetic and tensor methods of a
        device value, torch functions of one, containers holding one,
        attributes of an object that holds one;
      - host pulls end the taint: ``.cpu()``, ``.numpy()``, ``.item()``,
        ``.tolist()`` and ``np.*`` of a tensor.

    Interprocedurally (a fixpoint over the call graph): a function whose
    return value is a device value taints its call sites, a class that
    stores device values on ``self`` taints its constructor calls (as
    does a constructor given a device argument: the object may hold
    it), and a parameter is a device value when some resolved call site
    passes one. Each function's escapes (``self.attr = x``,
    ``self.attr[k] = x`` of a device value) feed ``rules_capacity``.
  * **Listener bridges** — classes that collect callbacks
    (``subscribe``/``add_*_listener`` registrars appending a function
    parameter to instance state) and later dispatch them (iterating the
    same container and calling the elements). The bridge pairs each
    dispatcher with the callbacks registered at project call sites of
    the matching registrar, giving ``reaches()`` the edge an event needs
    to travel from a mutation publisher through a subscription to a
    cache's invalidation hook.

The reference's SPMD side of this layer (mesh axes, PartitionSpecs,
donation, trace-static parameters) serves its SPMD family, which has no
counterpart here yet.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Set, Tuple

from filodb_tpu_torch.lint import ModuleSource
from filodb_tpu_torch.lint import callgraph as cgmod
from filodb_tpu_torch.lint.astwalk import walk_nodes

_TRACE_WRAPPERS = ("vmap", "compile")

# torch factories that allocate on the device named by their ``device=``
ALLOC_FACTORIES = frozenset({
    "zeros", "ones", "full", "empty", "as_tensor", "tensor", "arange",
    "linspace", "eye", "rand", "randn", "randint", "from_numpy",
})
# torch functions whose result lies where their operands (or ``device=``)
# lie
ALLOC_FOLLOWING = frozenset({
    "zeros_like", "ones_like", "full_like", "empty_like", "where", "cat",
    "stack", "concat", "concatenate",
})
# device -> host pulls: their results are host values
HOST_PULLS = frozenset({"cpu", "numpy", "item", "tolist"})
# tensor methods and attributes whose result is host metadata
_HOST_META = frozenset({
    "size", "dim", "numel", "data_ptr", "nbytes", "element_size",
    "is_contiguous", "stride", "storage_offset", "untyped_storage",
    "shape", "dtype", "device", "ndim", "is_cuda", "itemsize",
})
# methods that put their argument into the receiving container
_GROWTH_METHODS = frozenset({"append", "extend", "insert", "add"})
# builtins whose result is never a device tensor
_HOST_BUILTINS = frozenset({
    "int", "float", "bool", "str", "len", "repr", "isinstance", "range",
    "id", "hash", "print", "sorted", "min", "max", "sum", "any", "all",
    "getattr", "hasattr", "type", "format", "round", "abs",
})
_TORCH_DTYPES = frozenset({
    "float64", "float32", "float16", "bfloat16", "double", "float",
    "half", "int64", "int32", "int16", "int8", "uint8", "long", "int",
    "short", "bool", "complex64", "complex128",
})


def _dotted(node) -> Optional[str]:
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = _dotted(node.value)
        return f"{base}.{node.attr}" if base else None
    return None


def _leaf(node) -> Optional[str]:
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def own_nodes(fn_node) -> List[ast.AST]:
    """Body nodes excluding nested function/lambda bodies (those are
    their own closure members)."""
    out: List[ast.AST] = []
    stack = list(ast.iter_child_nodes(fn_node))
    while stack:
        n = stack.pop()
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.Lambda)):
            continue
        out.append(n)
        stack.extend(ast.iter_child_nodes(n))
    return out


def call_base(e: ast.Call) -> Optional[str]:
    """Dotted base of a call's function ('torch' for torch.zeros(...))."""
    d = _dotted(e.func)
    if d is None or "." not in d:
        return None
    return d.rsplit(".", 1)[0]


def dtype_aliases(tree: ast.Module) -> Set[str]:
    """Module-level names bound to a torch dtype (``F64 = torch.float64``)."""
    out: Set[str] = set()
    for node in tree.body:
        if isinstance(node, ast.Assign) and _is_dtype_expr(node.value,
                                                           set()):
            out.update(t.id for t in node.targets
                       if isinstance(t, ast.Name))
    return out


def _is_dtype_expr(e, aliases: Set[str]) -> bool:
    if isinstance(e, ast.Attribute):
        return e.attr == "dtype" or (e.attr in _TORCH_DTYPES
                                     and _dotted(e.value) == "torch")
    if isinstance(e, ast.Name):
        return e.id in aliases
    return False


def _has_device_kw(call: ast.Call) -> bool:
    return any(kw.arg == "device" for kw in call.keywords)


def is_device_alloc(call, aliases: Set[str] = frozenset()) -> bool:
    """``call`` manufactures a device tensor by itself: a torch factory
    given ``device=``, ``.cuda()``, or ``.to(x)`` whose target is not a
    dtype (a device, a device string, or another tensor)."""
    if not isinstance(call, ast.Call):
        return False
    leaf = _leaf(call.func)
    base = call_base(call)
    if leaf == "cuda" and isinstance(call.func, ast.Attribute) \
            and base != "torch":
        return True
    if leaf == "to" and isinstance(call.func, ast.Attribute):
        if _has_device_kw(call):
            return True
        if call.args:
            a = call.args[0]
            if isinstance(a, ast.Constant) and a.value == "cpu":
                return False
            return not _is_dtype_expr(a, aliases)
        return False
    if base in ("torch", "torch.func") \
            and leaf in ALLOC_FACTORIES | ALLOC_FOLLOWING:
        return _has_device_kw(call)
    return False


def is_host_pull(call) -> bool:
    """``.cpu()`` / ``.numpy()`` / ``.item()`` / ``.tolist()`` /
    ``.to("cpu")``."""
    if not isinstance(call, ast.Call) \
            or not isinstance(call.func, ast.Attribute):
        return False
    if call.func.attr in HOST_PULLS:
        return True
    return call.func.attr == "to" and any(
        isinstance(a, ast.Constant) and a.value == "cpu"
        for a in list(call.args) + [kw.value for kw in call.keywords])


def is_h2d_transfer(call, aliases: Set[str] = frozenset()) -> bool:
    """A host->device copy of its first argument or receiver:
    ``torch.as_tensor(x, device=)``, ``torch.tensor(x, device=)``,
    ``x.to(device)``, ``x.cuda()``."""
    if not isinstance(call, ast.Call):
        return False
    leaf = _leaf(call.func)
    if leaf in ("as_tensor", "tensor") and call_base(call) == "torch":
        return _has_device_kw(call)
    return leaf in ("to", "cuda") and is_device_alloc(call, aliases)


def h2d_source(call: ast.Call) -> Optional[ast.AST]:
    """The host value a transfer copies (argument or receiver)."""
    if _leaf(call.func) in ("as_tensor", "tensor"):
        return call.args[0] if call.args else None
    src = call.func.value if isinstance(call.func, ast.Attribute) else None
    # torch.from_numpy(x).to(dev) copies x
    if isinstance(src, ast.Call) and _leaf(src.func) == "from_numpy" \
            and src.args:
        return src.args[0]
    return src


def _wrapper_kind(fn_expr) -> Optional[str]:
    """'vmap' / 'compile' when the expression names a torch transform."""
    d = _dotted(fn_expr) or ""
    leaf = d.rsplit(".", 1)[-1]
    if leaf in _TRACE_WRAPPERS and (d.startswith("torch") or d == leaf):
        return leaf
    return None


@dataclass
class TraceSite:
    """One torch transform wrapping site."""
    kind: str                       # vmap | compile
    module: str
    relpath: str
    line: int
    body_keys: Tuple[str, ...]      # FuncInfo keys of the wrapped body


# -- device taint ------------------------------------------------------------

@dataclass
class Store:
    """One escape of a device value into a long-lived store."""
    label: str          # "self.attr" or "self.attr[]"
    line: int
    taint: str          # the tainted local, or "<alloc>" / "<call>"
    node: ast.AST


class FnTaint:
    """Device taint inside one function body, given the tainted
    parameters and the project facts of the enclosing fixpoint."""

    MAX_PASSES = 8

    def __init__(self, df: "DeviceDataflow", fi: cgmod.FuncInfo,
                 params: Set[str]):
        self.df = df
        self.fi = fi
        self.aliases = df.dtype_aliases.get(fi.module, set())
        self.tainted: Set[str] = set(params)
        # parameters bound, at some call site, to a device-returning
        # function (``make`` in ``_per_partition(make)``)
        self.device_fns: Set[str] = df.device_fn_params.get(fi.key, set())
        self.stores: List[Store] = []
        self.returns_device = False
        # which positions of a returned tuple are device values (None:
        # the whole return value)
        self.return_pos: Optional[Tuple[bool, ...]] = None
        self._whole_return = False
        # (callee keys, call node) of calls passing a device value
        self.tainted_calls: List[Tuple[Tuple[str, ...], ast.Call]] = []
        self._sites: Dict[int, List[cgmod.CallSite]] = {}
        for s in fi.sites:
            if s.kind == "call":
                self._sites.setdefault(s.line, []).append(s)
        nodes = own_nodes(fi.node)
        # taint-propagation passes to a fixpoint, then one recording pass:
        # stores must not duplicate across passes
        self._record = False
        for _ in range(self.MAX_PASSES):
            before = len(self.tainted)
            for node in nodes:
                self._visit(node)
            if len(self.tainted) == before:
                break
        self._record = True
        for node in nodes:
            self._visit(node)

    # -- expressions --------------------------------------------------------

    def callees(self, call: ast.Call) -> Tuple[str, ...]:
        leaf = _leaf(call.func)
        out: List[str] = []
        for s in self._sites.get(call.lineno, ()):
            if s.label.rsplit(".", 1)[-1] == leaf:
                out.extend(s.callees)
        if not out:
            k = self.df.module_attr_callee(self.fi.module, call.func)
            if k is not None:
                out.append(k)
        return tuple(out)

    def taint(self, e) -> Optional[str]:
        """The tainted local a value carries, '<alloc>' / '<call>' for a
        fresh device value, None for a host value."""
        if isinstance(e, ast.Name):
            return e.id if e.id in self.tainted else None
        if isinstance(e, ast.Call):
            return self._call_taint(e)
        if isinstance(e, ast.Subscript):
            return self.taint(e.value)
        if isinstance(e, ast.Attribute):
            if e.attr in _HOST_META or e.attr.endswith("_ms") \
                    or e.attr.startswith(("n_", "num_")):
                return None
            return self.taint(e.value)
        if isinstance(e, ast.BinOp):
            return "<alloc>" if (self.taint(e.left)
                                 or self.taint(e.right)) else None
        if isinstance(e, ast.UnaryOp):
            return "<alloc>" if self.taint(e.operand) else None
        if isinstance(e, ast.Compare):
            return "<alloc>" if any(
                self.taint(x) for x in [e.left, *e.comparators]) else None
        if isinstance(e, ast.IfExp):
            return self.taint(e.body) or self.taint(e.orelse)
        if isinstance(e, (ast.Tuple, ast.List, ast.Set)):
            for el in e.elts:
                t = self.taint(el)
                if t is not None:
                    return t
            return None
        if isinstance(e, ast.Dict):
            for v in e.values:
                t = self.taint(v)
                if t is not None:
                    return t
            return None
        if isinstance(e, ast.Starred):
            return self.taint(e.value)
        if isinstance(e, (ast.ListComp, ast.SetComp, ast.GeneratorExp)):
            return "<alloc>" if self.taint(e.elt) else None
        if isinstance(e, ast.DictComp):
            return "<alloc>" if self.taint(e.value) else None
        return None

    def _args_tainted(self, call: ast.Call) -> bool:
        return any(self.taint(a) for a in call.args) or any(
            self.taint(kw.value) for kw in call.keywords)

    def _call_taint(self, call: ast.Call) -> Optional[str]:
        f = call.func
        leaf = _leaf(f)
        if is_host_pull(call):
            return None
        if is_device_alloc(call, self.aliases):
            return "<alloc>"
        base = call_base(call) or ""
        root = base.split(".", 1)[0]
        if isinstance(f, ast.Name) and f.id in _HOST_BUILTINS:
            return None
        if root in ("np", "numpy", "math", "json", "time", "os"):
            return None
        if root == "torch" and not base.startswith("torch.cuda"):
            if leaf in ALLOC_FACTORIES:
                return None         # host factory (no device=)
            return "<alloc>" if self._args_tainted(call) else None
        # method of a device value: a derived tensor, unless metadata
        if isinstance(f, ast.Attribute) and self.taint(f.value):
            if f.attr in _HOST_META:
                return None
            keys = self.callees(call)
            if not keys:
                return "<alloc>"
            if any(k in self.df.device_returning for k in keys):
                return "<call>"
            return None
        if isinstance(f, ast.Name) and f.id in self.device_fns:
            return "<call>"
        keys = self.callees(call)
        for k in keys:
            if k in self.df.device_returning:
                return "<call>"
            if k.endswith(".__init__"):
                cls = self.df.cg.funcs[k]
                if (cls.module, cls.cls) in self.df.device_classes \
                        or self._args_tainted(call):
                    return "<call>"
        if not keys and isinstance(f, ast.Name):
            ent = self.df.cg._scopes.get(self.fi.module, {}).get(f.id)
            if ent and ent[0] == "class":
                ci = self.df.cg.classes.get(ent[1])
                if ci is not None and (
                        (ci.module, ci.name) in self.df.device_classes
                        or self._args_tainted(call)):
                    return "<call>"
        return None

    # -- statements ---------------------------------------------------------

    def _visit_call(self, node: ast.Call) -> None:
        f = node.func
        tainted_args = self._args_tainted(node)
        # container growth: local.append(x) makes the local a container
        # of device values; self.attr.append(x) grows a long-lived store
        if tainted_args and isinstance(f, ast.Attribute) \
                and f.attr in _GROWTH_METHODS:
            if isinstance(f.value, ast.Name):
                self.tainted.add(f.value.id)
            attr = _self_attr(f.value)
            if attr is not None and self._record:
                taint = next(t for t in (
                    [self.taint(a) for a in node.args]
                    + [self.taint(kw.value) for kw in node.keywords])
                    if t)
                self.stores.append(Store(f"self.{attr}[]", node.lineno,
                                         taint, node))
            return
        if not self._record:
            return
        keys = self.callees(node)
        if keys and (tainted_args or self._passes_device_fn(node)):
            self.tainted_calls.append((keys, node))

    def _unpack_positions(self, value, n: int
                          ) -> Optional[Tuple[bool, ...]]:
        """Per-position device taint of ``a, b = value``: a tuple literal
        element by element, a project call by its returns' positions;
        None when every name takes the taint."""
        if isinstance(value, (ast.Tuple, ast.List)) \
                and len(value.elts) == n:
            return tuple(self.taint(e) is not None for e in value.elts)
        if isinstance(value, ast.Call):
            poss = [self.df.return_pos.get(k)
                    for k in self.callees(value)
                    if k in self.df.device_returning]
            if poss and all(p is not None and len(p) == n for p in poss):
                return tuple(any(p[i] for p in poss) for i in range(n))
        return None

    def _passes_device_fn(self, node: ast.Call) -> bool:
        return any(c in self.df.device_returning
                   for s in self.fi.sites
                   if s.kind == "callback" and s.line == node.lineno
                   for c in s.callees)


    def _visit(self, node) -> None:
        if isinstance(node, ast.Return) and node.value is not None:
            if self.taint(node.value):
                self.returns_device = True
                v = node.value
                pos = tuple(self.taint(e) is not None for e in v.elts) \
                    if isinstance(v, ast.Tuple) else None
                if pos is None or self.return_pos is None:
                    self.return_pos = None if pos is None \
                        or self._whole_return else pos
                    self._whole_return = self._whole_return or pos is None
                elif len(pos) == len(self.return_pos):
                    self.return_pos = tuple(
                        a or b for a, b in zip(pos, self.return_pos))
                else:
                    self.return_pos, self._whole_return = None, True
            return
        if isinstance(node, ast.Call):
            self._visit_call(node)
            return
        if isinstance(node, (ast.For, ast.comprehension)):
            if self.taint(node.iter) and isinstance(node.target, ast.Name):
                self.tainted.add(node.target.id)
            return
        if not isinstance(node, (ast.Assign, ast.AugAssign,
                                 ast.AnnAssign)):
            return
        targets = node.targets if isinstance(node, ast.Assign) \
            else [node.target]
        value = node.value
        if value is None:
            return
        taint = self.taint(value)
        for t in targets:
            if isinstance(t, ast.Name):
                if taint is not None:
                    self.tainted.add(t.id)
                continue
            if isinstance(t, (ast.Tuple, ast.List)) and taint is not None:
                pos = self._unpack_positions(value, len(t.elts))
                for i, e in enumerate(t.elts):
                    if pos is not None and not pos[i]:
                        continue
                    if isinstance(e, ast.Name):
                        self.tainted.add(e.id)
                    elif isinstance(e, ast.Starred) \
                            and isinstance(e.value, ast.Name):
                        self.tainted.add(e.value.id)
                continue
            attr = _self_attr(t)
            if attr is not None and taint is not None:
                if self._record:
                    self.stores.append(Store(f"self.{attr}", node.lineno,
                                             taint, t))
                continue
            if isinstance(t, ast.Subscript) and taint is not None:
                attr = _self_attr(t.value)
                if attr is not None:
                    # self.attr[k] = X — store growth
                    if self._record:
                        self.stores.append(Store(f"self.{attr}[]",
                                                 node.lineno, taint, t))
                elif isinstance(t.value, ast.Name):
                    # local[k] = device value: the container holds it
                    self.tainted.add(t.value.id)


def _self_attr(e) -> Optional[str]:
    """'attr' when ``e`` is ``self.attr``, else None."""
    if isinstance(e, ast.Attribute) and isinstance(e.value, ast.Name) \
            and e.value.id == "self":
        return e.attr
    return None


def _params(node) -> List[str]:
    a = node.args
    return [p.arg for p in (*a.posonlyargs, *a.args, *a.kwonlyargs)]


class DeviceDataflow:
    """Trace sites, device taint and listener bridges over one
    CallGraph."""

    # rounds of the interprocedural taint fixpoint (each round carries
    # taint one call edge further)
    TAINT_ROUNDS = 12

    def __init__(self, mods: Sequence[ModuleSource], cg: cgmod.CallGraph):
        self.mods = list(mods)
        self.cg = cg
        self.sites: List[TraceSite] = []
        self.traced: Set[str] = set()
        self.dtype_aliases: Dict[str, Set[str]] = {
            cgmod.module_dotted(m.relpath): dtype_aliases(m.tree)
            for m in mods}
        self._funcinfo_by_node: Dict[int, cgmod.FuncInfo] = {
            id(fi.node): fi for fi in cg.funcs.values()}
        self._lambda_by_line: Dict[Tuple[str, int], str] = {}
        for key, fi in cg.funcs.items():
            if fi.name == "<lambda>":
                self._lambda_by_line.setdefault(
                    (fi.module, fi.lineno), key)
        # func key -> directly nested (lexical) function keys
        self._lexical_children: Dict[str, List[str]] = {}
        for key, fi in cg.funcs.items():
            if ".<locals>." in fi.qualname:
                pq = fi.qualname.rsplit(".<locals>.", 1)[0]
                self._lexical_children.setdefault(
                    f"{fi.module}:{pq}", []).append(key)
        self._discover_sites()
        for site in self.sites:
            self.traced |= self.closure_of(site.body_keys)
        self._taint_fixpoint()
        self._build_bridges()

    def module_attr_callee(self, module: str, func) -> Optional[str]:
        """``alias.name(...)`` where ``alias`` is a project module imported
        with ``from pkg import mod as alias`` (the call graph resolves
        only ``import pkg.mod as alias``): the function's key, or the
        class's ``__init__`` key."""
        if not isinstance(func, ast.Attribute) \
                or not isinstance(func.value, ast.Name):
            return None
        ent = self.cg._scopes.get(module, {}).get(func.value.id)
        if not ent or ent[0] != "import_from":
            return None
        pkg, _, name = ent[1].partition(":")
        target = f"{pkg}.{name}"
        key = f"{target}:{func.attr}"
        if key in self.cg.funcs:
            return key
        ci = self.cg._classes_by_mod.get((target, func.attr))
        if ci is not None and "__init__" in ci.methods:
            return ci.methods["__init__"].key
        return None

    # -- trace sites --------------------------------------------------------

    def _body_keys_for(self, mod_dotted: str, expr) -> Tuple[str, ...]:
        if isinstance(expr, ast.Lambda):
            k = self._lambda_by_line.get((mod_dotted, expr.lineno))
            return (k,) if k else ()
        if isinstance(expr, ast.Call):
            d = _dotted(expr.func) or ""
            if d.rsplit(".", 1)[-1] == "partial" and expr.args:
                return self._body_keys_for(mod_dotted, expr.args[0])
            return ()
        name = _leaf(expr)
        if name is None:
            return ()
        return tuple(k for k, fi in self.cg.funcs.items()
                     if fi.module == mod_dotted and fi.name == name)

    def _discover_sites(self) -> None:
        for mod in self.mods:
            dotted = cgmod.module_dotted(mod.relpath)
            for node in walk_nodes(mod.tree):
                if isinstance(node, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                    fi = self._funcinfo_by_node.get(id(node))
                    for d in node.decorator_list:
                        target = d.func if isinstance(d, ast.Call) else d
                        kind = _wrapper_kind(target)
                        if kind and fi is not None:
                            self.sites.append(TraceSite(
                                kind, dotted, mod.relpath, d.lineno,
                                (fi.key,)))
                elif isinstance(node, ast.Call) and node.args:
                    kind = _wrapper_kind(node.func)
                    if kind:
                        self.sites.append(TraceSite(
                            kind, dotted, mod.relpath, node.lineno,
                            self._body_keys_for(dotted, node.args[0])))

    def closure_of(self, keys: Sequence[str]) -> Set[str]:
        seen: Set[str] = set()
        stack = [k for k in keys if k in self.cg.funcs]
        while stack:
            k = stack.pop()
            if k in seen:
                continue
            seen.add(k)
            fi = self.cg.funcs[k]
            for s in fi.sites:
                if s.kind in ("call", "callback"):
                    for c in s.callees:
                        if c not in seen and c in self.cg.funcs:
                            stack.append(c)
            # lexically nested functions run under the same transform
            for k2 in self._lexical_children.get(k, ()):
                if k2 not in seen:
                    stack.append(k2)
        return seen

    # -- device taint -------------------------------------------------------

    def _taint_fixpoint(self) -> None:
        """Device-returning functions, device-holding classes and
        device parameters, to a fixpoint; then each host function's
        escapes under the final facts (``self.escapes``)."""
        self.device_returning: Set[str] = set()
        self.return_pos: Dict[str, Optional[Tuple[bool, ...]]] = {}
        self.device_classes: Set[Tuple[str, str]] = set()
        self.device_params: Dict[str, Set[str]] = {}
        self.device_fn_params: Dict[str, Set[str]] = {}
        keys = [k for k, fi in sorted(self.cg.funcs.items())
                if k not in self.traced
                and not isinstance(fi.node, ast.Lambda)]
        taints: Dict[str, FnTaint] = {}
        for _ in range(self.TAINT_ROUNDS):
            changed = False
            for key in keys:
                fi = self.cg.funcs[key]
                t = FnTaint(self, fi, self.device_params.get(key, set()))
                taints[key] = t
                if t.returns_device and (
                        key not in self.device_returning
                        or self.return_pos.get(key) != t.return_pos):
                    self.device_returning.add(key)
                    self.return_pos[key] = t.return_pos
                    changed = True
                if fi.cls and any(s.label.startswith("self.")
                                  for s in t.stores):
                    ck = (fi.module, fi.cls)
                    if ck not in self.device_classes:
                        self.device_classes.add(ck)
                        changed = True
                for callee_keys, call in t.tainted_calls:
                    for ck in callee_keys:
                        if self._taint_params(t, ck, call):
                            changed = True
            if not changed:
                break
        self.escapes: Dict[str, FnTaint] = {
            k: t for k, t in taints.items() if t.stores}

    def _taint_params(self, t: FnTaint, callee: str,
                      call: ast.Call) -> bool:
        cfi = self.cg.funcs.get(callee)
        if cfi is None or isinstance(cfi.node, ast.Lambda):
            return False
        params = _params(cfi.node)
        drop = 1 if (cfi.cls and params and params[0] in ("self", "cls")
                     and (isinstance(call.func, ast.Attribute)
                          or cfi.name == "__init__")) else 0
        got = self.device_params.setdefault(callee, set())
        fns = self.device_fn_params.setdefault(callee, set())
        before = len(got) + len(fns)
        dev_fn_names = {self.cg.funcs[c].name
                        for s in t.fi.sites
                        if s.kind == "callback" and s.line == call.lineno
                        for c in s.callees if c in self.device_returning}
        bound = [(params[i + drop], a) for i, a in enumerate(call.args)
                 if i + drop < len(params)]
        stop = next((i for i, a in enumerate(call.args)
                     if isinstance(a, ast.Starred)), None)
        if stop is not None:
            bound = bound[:stop]
        bound += [(kw.arg, kw.value) for kw in call.keywords
                  if kw.arg and kw.arg in params]
        for p, a in bound:
            if t.taint(a):
                got.add(p)
            elif _leaf(a) in dev_fn_names:
                fns.add(p)
        return len(got) + len(fns) != before

    # -- listener bridges ---------------------------------------------------

    def _build_bridges(self) -> None:
        cg = self.cg
        # (class name, attr) -> registrar FuncInfo keys
        registrars: Dict[Tuple[str, str], List[str]] = {}
        # (class name, attr) -> dispatcher FuncInfo keys
        dispatchers: Dict[Tuple[str, str], List[str]] = {}
        for ci in cg._classes_by_mod.values():
            for mname, mfi in ci.methods.items():
                node = mfi.node
                params = {a.arg for a in node.args.args} - {"self"}
                for sub in walk_nodes(node):
                    # registrar: self.<attr>.append(<param>)
                    if isinstance(sub, ast.Call) \
                            and isinstance(sub.func, ast.Attribute) \
                            and sub.func.attr in ("append", "add") \
                            and isinstance(sub.func.value, ast.Attribute) \
                            and isinstance(sub.func.value.value, ast.Name) \
                            and sub.func.value.value.id == "self" \
                            and len(sub.args) == 1 \
                            and isinstance(sub.args[0], ast.Name) \
                            and sub.args[0].id in params:
                        registrars.setdefault(
                            (ci.name, sub.func.value.attr), []).append(
                                mfi.key)
                    # dispatcher: for cb in [list(]self.<attr>[)]: cb(...)
                    if isinstance(sub, ast.For) \
                            and isinstance(sub.target, ast.Name):
                        attr = self._self_attr_in_iter(sub.iter)
                        if attr is None:
                            continue
                        tgt = sub.target.id
                        for inner in ast.walk(sub):
                            if isinstance(inner, ast.Call) \
                                    and isinstance(inner.func, ast.Name) \
                                    and inner.func.id == tgt:
                                dispatchers.setdefault(
                                    (ci.name, attr), []).append(mfi.key)
                                break
        # registrar method name -> [(class, attr)] for unresolved calls
        by_name: Dict[str, List[Tuple[str, str]]] = {}
        reg_keys: Dict[str, Tuple[str, str]] = {}
        for (cls, attr), keys in registrars.items():
            for k in keys:
                reg_keys[k] = (cls, attr)
                by_name.setdefault(cg.funcs[k].name, []).append(
                    (cls, attr))
        # registered callbacks per (class, attr)
        callbacks: Dict[Tuple[str, str], Set[str]] = {}
        for fi in cg.funcs.values():
            call_sites = [s for s in fi.sites if s.kind == "call"]
            cb_sites = [s for s in fi.sites if s.kind == "callback"]
            for s in call_sites:
                target: Optional[Tuple[str, str]] = None
                for c in s.callees:
                    if c in reg_keys:
                        target = reg_keys[c]
                        break
                if target is None:
                    # unresolved receiver: accept a UNIQUE registrar name
                    name = s.label.rsplit(".", 1)[-1]
                    owners = by_name.get(name, [])
                    if len(set(owners)) == 1 and not s.callees:
                        target = owners[0]
                if target is None:
                    continue
                for s2 in cb_sites:
                    if s2.line == s.line:
                        callbacks.setdefault(target, set()).update(
                            s2.callees)
        # bridge edges: dispatcher -> registered callbacks
        self.bridge_edges: Dict[str, Set[str]] = {}
        for key, disp_keys in dispatchers.items():
            cbs = callbacks.get(key)
            if not cbs:
                continue
            for dk in disp_keys:
                self.bridge_edges.setdefault(dk, set()).update(cbs)

    def reaches(self, start: str, target: str,
                max_depth: int = 64) -> Optional[List[str]]:
        """A call-graph path (list of func keys) from ``start`` to
        ``target`` over call/callback/thread + bridge edges, or None."""
        if start == target:
            return [start]
        prev: Dict[str, str] = {}
        seen = {start}
        frontier = [start]
        depth = 0
        while frontier and depth < max_depth:
            depth += 1
            nxt: List[str] = []
            for k in frontier:
                fi = self.cg.funcs.get(k)
                succ: Set[str] = set(self.bridge_edges.get(k, ()))
                if fi is not None:
                    for s in fi.sites:
                        succ.update(s.callees)
                for c in succ:
                    if c in seen:
                        continue
                    seen.add(c)
                    prev[c] = k
                    if c == target:
                        path = [c]
                        while path[-1] != start:
                            path.append(prev[path[-1]])
                        return list(reversed(path))
                    nxt.append(c)
            frontier = nxt
        return None

    @staticmethod
    def _self_attr_in_iter(it) -> Optional[str]:
        """`self.<attr>` mentioned by a for-iter expression (directly,
        or through list(...)/tuple(...)/.values())."""
        cand = it
        if isinstance(cand, ast.Call):
            if isinstance(cand.func, ast.Name) \
                    and cand.func.id in ("list", "tuple", "sorted") \
                    and cand.args:
                cand = cand.args[0]
            elif isinstance(cand.func, ast.Attribute) \
                    and cand.func.attr == "values":
                cand = cand.func.value
        if isinstance(cand, ast.Attribute) \
                and isinstance(cand.value, ast.Name) \
                and cand.value.id == "self":
            return cand.attr
        return None


def build(mods: Sequence[ModuleSource],
          cg: Optional[cgmod.CallGraph] = None) -> DeviceDataflow:
    if cg is None:
        cg = cgmod.build(mods)
    return DeviceDataflow(mods, cg)
