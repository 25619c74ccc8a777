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

  * **Transform bodies through their parameters** — a transform site's
    lambda that calls a parameter of its enclosing function
    (``vmap(lambda s, e: body(s, e, step))``) runs whatever the callers
    bind that parameter to: the functions named directly or through
    ``functools.partial`` at the enclosing function's project call
    sites join the site's bodies. The positions the lambda feeds with
    its own (batched) parameters, past the partial's bound ones, are the
    bodies' batched parameters (``batched``), carried into their callees
    by argument.
  * **Collectives** (the SPMD half, retargeted from the reference's
    ``shard_map``/``psum`` sites) — every cross-process collective of
    ``torch.distributed`` (``all_reduce``, ``all_gather``,
    ``broadcast``, ``reduce_scatter``, ``barrier``, ...), every call of
    a project function that reaches one (``parallel/distributed.
    _all_reduce``: a wrapper whose ``op`` parameter is forwarded, so the
    op is read at the wrapper's call sites), and every in-process
    partition fold (a project ``psum``/``pmin``/``pmax``/``all_gather``:
    ``parallel/mesh.py``), whose grouping follows the partition count.
    ``spmd_reachable`` is the set of functions that reach either kind.
  * **Rank-invariance** (the reference's static-ness) — which values
    hold the same on every rank of a group: parameters declared with
    :func:`~filodb_tpu_torch.lint.ranks.rank_invariant` (or bound to
    invariant values at every project call site), constants, imports,
    and the result of an earlier collective; rank reads, the clock, the
    environment and RNG are rank-dependent, as is a rank's own data
    until a collective agrees on it. Whether a value is ``None`` is
    tracked apart (``none_inv``): ``x is None`` is rank-invariant when
    every ``None`` that can reach ``x`` is chosen by invariant tests,
    through project calls' returns.
  * **In-place writers** (the counterpart of donation) — functions that
    ``.copy_``, ``index_copy_`` or slice-assign into a parameter's
    storage, and each project call site of one with the argument
    expressions it writes into (``inplace_calls``).
"""

from __future__ import annotations

import ast
from dataclasses import dataclass
from typing import Dict, FrozenSet, List, Optional, Sequence, Set, Tuple

from filodb_tpu_torch.lint import ModuleSource
from filodb_tpu_torch.lint import callgraph as cgmod
from filodb_tpu_torch.lint.astwalk import own_nodes, walk_nodes

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
    bound: int = 0                  # positionals a partial binds first


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
        # the taint fixpoint leaves out only the bodies a site names
        # itself: the bodies resolved through a parameter below also run
        # eagerly, outside any transform
        self._taint_fixpoint()
        self._build_bridges()
        self._sites_at_line: Dict[str, Dict[int, List[cgmod.CallSite]]] = {}
        self._calls: Dict[str, List[Tuple[ast.Call, Tuple[str, ...]]]] = {}
        self._imports: Dict[str, Dict[str, str]] = {}
        self._resolve_site_params()
        self._discover_spmd()
        self._discover_inplace()

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
            return (k,) if k else self._register_lambda(mod_dotted, expr)
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

    def _register_lambda(self, mod_dotted: str,
                         lam: ast.Lambda) -> Tuple[str, ...]:
        """A transform's lambda the call graph did not reach (the callee
        of a call, ``vmap(lambda ...)(x)``): indexed here, inside the def
        that holds it, with its own call sites."""
        encl = None
        for fi in self.cg.funcs.values():
            if fi.module != mod_dotted or isinstance(fi.node, ast.Lambda):
                continue
            end = getattr(fi.node, "end_lineno", fi.lineno)
            if fi.lineno <= lam.lineno <= end and (
                    encl is None or fi.lineno > encl.lineno):
                encl = fi
        if encl is None:
            return ()
        key = f"{mod_dotted}:{encl.qualname}.<locals>.<lambda@{lam.lineno}>"
        fi = cgmod.FuncInfo(key=key, relpath=encl.relpath,
                            module=mod_dotted, cls=encl.cls,
                            name="<lambda>",
                            qualname=f"{encl.qualname}.<lambda>", node=lam,
                            lineno=lam.lineno)
        self.cg.funcs[key] = fi
        cgmod._BodyWalker(self.cg, fi).run()
        self._funcinfo_by_node[id(lam)] = fi
        self._lambda_by_line[(mod_dotted, lam.lineno)] = key
        return (key,)

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
                        body = node.args[0]
                        bound = len(body.args) - 1 if isinstance(
                            body, ast.Call) and body.args else 0
                        self.sites.append(TraceSite(
                            kind, dotted, mod.relpath, node.lineno,
                            self._body_keys_for(dotted, body), bound))

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
        # functions holding a device tensor (the numerics family's scope)
        self.device_fns: Set[str] = {
            k for k, t in taints.items()
            if t.tainted or t.returns_device or t.tainted_calls}

    def _taint_params(self, t: FnTaint, callee: str,
                      call: ast.Call) -> bool:
        cfi = self.cg.funcs.get(callee)
        if cfi is None or isinstance(cfi.node, ast.Lambda):
            return False
        got = self.device_params.setdefault(callee, set())
        fns = self.device_fn_params.setdefault(callee, set())
        before = len(got) + len(fns)
        dev_fn_names = {self.cg.funcs[c].name
                        for s in t.fi.sites
                        if s.kind == "callback" and s.line == call.lineno
                        for c in s.callees if c in self.device_returning}
        for p, a in self.bind_args(cfi, call):
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

    # -- calls --------------------------------------------------------------

    def sites_at(self, fi: cgmod.FuncInfo, line: int) -> List[cgmod.CallSite]:
        idx = self._sites_at_line.get(fi.key)
        if idx is None:
            idx = {}
            for s in fi.sites:
                idx.setdefault(s.line, []).append(s)
            self._sites_at_line[fi.key] = idx
        return idx.get(line, [])

    def calls_of(self, key: str
                 ) -> List[Tuple[ast.Call, Tuple[str, ...]]]:
        """(call, project targets) of every call in ``key``'s own body."""
        got = self._calls.get(key)
        if got is None:
            fi = self.cg.funcs[key]
            got = [(n, self.call_targets(fi, n)) for n in own_nodes(fi.node)
                   if isinstance(n, ast.Call)]
            self._calls[key] = got
        return got

    def _local_imports(self, fi: cgmod.FuncInfo) -> Dict[str, str]:
        """Function-local ``from pkg.mod import name`` bindings of the def
        ``fi`` sits in: name -> function key."""
        scope = self._enclosing_def(fi)
        if scope is None:
            return {}
        got = self._imports.get(scope.key)
        if got is None:
            got = {}
            for node in walk_nodes(scope.node):
                if isinstance(node, ast.ImportFrom) and node.module:
                    for a in node.names:
                        k = f"{node.module}:{a.name}"
                        if k in self.cg.funcs:
                            got[a.asname or a.name] = k
            self._imports[scope.key] = got
        return got

    def resolve_name(self, fi: cgmod.FuncInfo, name: str) -> Optional[str]:
        """The project function a bare name denotes inside ``fi``: a nested
        or sibling def, a module-level def or import, or a function-local
        ``from pkg.mod import name`` (which the call graph leaves
        unresolved)."""
        for qual in (f"{fi.qualname}.<locals>.{name}",
                     f"{fi.qualname.rsplit('.<locals>.', 1)[0]}"
                     f".<locals>.{name}"):
            if f"{fi.module}:{qual}" in self.cg.funcs:
                return f"{fi.module}:{qual}"
        ent = self.cg._scopes.get(fi.module, {}).get(name)
        if ent and ent[0] == "func":
            return ent[1]
        if ent and ent[0] == "import_from":
            k = ent[1]
            if k in self.cg.funcs:
                return k
        return self._local_imports(fi).get(name)

    def _enclosing_def(self, fi: cgmod.FuncInfo) -> Optional[cgmod.FuncInfo]:
        """``fi`` itself, or for a lambda the def it sits in."""
        if not isinstance(fi.node, ast.Lambda):
            return fi
        parent = fi.qualname.rsplit(".", 1)[0]
        return self.cg.funcs.get(f"{fi.module}:{parent}")

    def call_targets(self, fi: cgmod.FuncInfo, call: ast.Call
                     ) -> Tuple[str, ...]:
        """Project functions ``call`` (inside ``fi``) may run: the call
        graph's resolution, imported-module attributes, function-local
        imports, and both branches of ``(f if c else g)(...)``."""
        f = call.func
        if isinstance(f, ast.IfExp):
            out = []
            for br in (f.body, f.orelse):
                k = self.resolve_name(fi, br.id) \
                    if isinstance(br, ast.Name) else None
                if k:
                    out.append(k)
            return tuple(out)
        leaf = _leaf(f)
        out = [c for s in self.sites_at(fi, call.lineno)
               if s.kind == "call" and s.label.rsplit(".", 1)[-1] == leaf
               for c in s.callees]
        if not out:
            k = self.module_attr_callee(fi.module, f)
            if k is None and isinstance(f, ast.Name):
                k = self.resolve_name(fi, f.id)
            if k is not None:
                out.append(k)
        return tuple(out)

    @staticmethod
    def bind_args(cfi: cgmod.FuncInfo, call: ast.Call
                  ) -> List[Tuple[str, ast.AST]]:
        """(parameter, argument) pairs of ``call`` into ``cfi``: positional
        up to the first starred argument, then keywords; ``self``/``cls``
        dropped for a method called through an attribute or a class."""
        params = _params(cfi.node)
        drop = 1 if (cfi.cls and params and params[0] in ("self", "cls")
                     and (isinstance(call.func, ast.Attribute)
                          or cfi.name == "__init__")) else 0
        out = []
        for i, a in enumerate(call.args):
            if isinstance(a, ast.Starred) or i + drop >= len(params):
                break
            out.append((params[i + drop], a))
        out += [(kw.arg, kw.value) for kw in call.keywords
                if kw.arg and kw.arg in params]
        return out

    # -- transform bodies bound through a parameter ---------------------------

    def _partial_target(self, fi: cgmod.FuncInfo, expr,
                        depth: int = 0) -> List[Tuple[str, int]]:
        """(function key, positional arguments bound) of a callable
        expression in ``fi``: a function name, ``functools.partial(f,
        a, b)``, or a local bound to one of those."""
        if depth > 3:
            return []
        if isinstance(expr, ast.Call):
            d = _dotted(expr.func) or ""
            if d.rsplit(".", 1)[-1] == "partial" and expr.args:
                n = 0
                for a in expr.args[1:]:
                    k = self._starred_len(fi, a) \
                        if isinstance(a, ast.Starred) else 1
                    n = None if n is None or k is None else n + k
                return [(k, None if n is None or m is None else n + m)
                        for k, m in self._partial_target(fi, expr.args[0],
                                                         depth + 1)]
            return []
        if not isinstance(expr, ast.Name):
            return []
        k = self.resolve_name(fi, expr.id)
        if k is not None:
            return [(k, 0)]
        out: List[Tuple[str, int]] = []
        for node in own_nodes(fi.node):
            if isinstance(node, ast.Assign) and any(
                    isinstance(t, ast.Name) and t.id == expr.id
                    for t in node.targets):
                out += self._partial_target(fi, node.value, depth + 1)
        return out

    @staticmethod
    def _starred_len(fi: cgmod.FuncInfo, a: ast.Starred) -> Optional[int]:
        """How many arguments ``*name`` spreads, when ``name`` is a local
        bound once to a tuple or list literal."""
        if isinstance(a.value, (ast.Tuple, ast.List)):
            return len(a.value.elts)
        if not isinstance(a.value, ast.Name):
            return None
        vals = [n.value for n in own_nodes(fi.node)
                if isinstance(n, ast.Assign) and any(
                    isinstance(t, ast.Name) and t.id == a.value.id
                    for t in n.targets)]
        if len(vals) == 1 and isinstance(vals[0], (ast.Tuple, ast.List)) \
                and not any(isinstance(e, ast.Starred) for e in vals[0].elts):
            return len(vals[0].elts)
        return None

    def _resolve_site_params(self) -> None:
        """Widen each transform site whose lambda body calls a parameter
        of its enclosing function by the functions the project's call
        sites bind to that parameter, and mark the bodies' batched
        parameters (those the lambda feeds its own parameters)."""
        # func key -> parameters a transform batches (vmap's inputs)
        self.batched: Dict[str, Set[str]] = {}
        callers: Dict[str, List[Tuple[cgmod.FuncInfo, ast.Call]]] = {}
        for site in self.sites:
            for bk in list(site.body_keys):
                bfi = self.cg.funcs.get(bk)
                if bfi is None:
                    continue
                lam_params = _params(bfi.node)
                self.batched.setdefault(bk, set()).update(
                    lam_params[site.bound:])
                if not isinstance(bfi.node, ast.Lambda):
                    continue
                encl = self._enclosing_def(bfi)
                if encl is None:
                    continue
                eparams = _params(encl.node)
                for node in walk_nodes(bfi.node.body):
                    if not (isinstance(node, ast.Call)
                            and isinstance(node.func, ast.Name)
                            and node.func.id in eparams
                            and node.func.id not in lam_params):
                        continue
                    pname = node.func.id
                    fed = [i for i, a in enumerate(node.args)
                           if isinstance(a, ast.Name) and a.id in lam_params]
                    if encl.key not in callers:
                        callers[encl.key] = self._callers_of(encl.key)
                    for cfi, call in callers[encl.key]:
                        arg = dict(self.bind_args(encl, call)).get(pname)
                        if arg is None:
                            continue
                        for k, nbound in self._partial_target(cfi, arg):
                            tfi = self.cg.funcs.get(k)
                            if tfi is None:
                                continue
                            if k not in site.body_keys:
                                site.body_keys = site.body_keys + (k,)
                            tp = _params(tfi.node)
                            got = self.batched.setdefault(k, set())
                            if nbound is None:
                                # an unknown spread: every parameter the
                                # lambda could feed counts as batched
                                got.update(tp)
                                continue
                            got.update(tp[nbound + i] for i in fed
                                       if nbound + i < len(tp))
        for site in self.sites:
            self.traced |= self.closure_of(site.body_keys)
        # batched values flow into the callees they are passed to
        for _ in range(4):
            grew = False
            for k in sorted(self.traced):
                fi = self.cg.funcs.get(k)
                bat = self.batched_names(k)
                if fi is None or not bat:
                    continue
                for node, targets in self.calls_of(k):
                    for ck in targets:
                        cfi = self.cg.funcs.get(ck)
                        if cfi is None or ck not in self.traced:
                            continue
                        got = self.batched.setdefault(ck, set())
                        for p, a in self.bind_args(cfi, node):
                            if p not in got and any(
                                    isinstance(n, ast.Name) and n.id in bat
                                    for n in ast.walk(a)):
                                got.add(p)
                                grew = True
            if not grew:
                break

    def batched_names(self, key: str) -> Set[str]:
        """``key``'s batched parameters and the locals computed from
        them."""
        bat = set(self.batched.get(key, ()))
        fi = self.cg.funcs.get(key)
        if not bat or fi is None:
            return bat
        for _ in range(3):
            grew = False
            for node in own_nodes(fi.node):
                if not isinstance(node, (ast.Assign, ast.AugAssign,
                                         ast.AnnAssign)) \
                        or node.value is None:
                    continue
                if not any(isinstance(n, ast.Name) and n.id in bat
                           for n in ast.walk(node.value)):
                    continue
                for t in (node.targets if isinstance(node, ast.Assign)
                          else [node.target]):
                    names = t.elts if isinstance(t, (ast.Tuple, ast.List)) \
                        else [t]
                    for n in names:
                        if isinstance(n, ast.Starred):
                            n = n.value
                        if isinstance(n, ast.Name) and n.id not in bat:
                            bat.add(n.id)
                            grew = True
            if not grew:
                break
        return bat

    def _callers_of(self, key: str
                    ) -> List[Tuple[cgmod.FuncInfo, ast.Call]]:
        """Every project call site of ``key``."""
        return [(self.cg.funcs[k], node) for k in sorted(self.cg.funcs)
                for node, targets in self.calls_of(k) if key in targets]

    # -- collectives --------------------------------------------------------

    def is_process_collective(self, module: str, call: ast.Call) -> bool:
        """A ``torch.distributed`` collective primitive."""
        leaf = _leaf(call.func)
        if leaf not in PROCESS_COLLECTIVES:
            return False
        aliases, names = self._dist_names.get(module, (set(), set()))
        if isinstance(call.func, ast.Name):
            return call.func.id in names
        d = _dotted(call.func) or ""
        base = d.rsplit(".", 1)[0]
        return base == "torch.distributed" or base in aliases

    def _fold_leaves(self, fi: cgmod.FuncInfo, call: ast.Call) -> List[str]:
        f = call.func
        cands = [f.body, f.orelse] if isinstance(f, ast.IfExp) else [f]
        out = []
        for c in cands:
            if isinstance(c, ast.Name) and c.id in PARTITION_FOLDS:
                k = self.resolve_name(fi, c.id)
                if k is not None and self.cg.funcs[k].name == c.id:
                    out.append(c.id)
            elif isinstance(c, ast.Attribute) and c.attr in PARTITION_FOLDS:
                k = self.module_attr_callee(fi.module, c)
                if k is not None:
                    out.append(c.attr)
        return out

    def _discover_spmd(self) -> None:
        self._dist_names = {cgmod.module_dotted(m.relpath): _dist_names(m.tree)
                            for m in self.mods}
        self.collective_sites: List[CollectiveSite] = []
        prim_fns: Set[str] = set()
        fold_fns: Set[str] = set()
        for key, fi in self.cg.funcs.items():
            for node in own_nodes(fi.node):
                if not isinstance(node, ast.Call):
                    continue
                if self.is_process_collective(fi.module, node):
                    leaf = _leaf(node.func)
                    opnd = 1 if leaf.startswith("reduce_scatter") else 0
                    self.collective_sites.append(CollectiveSite(
                        "process", key, fi.relpath, node, leaf,
                        operand=node.args[opnd]
                        if len(node.args) > opnd else None,
                        op=_op_arg(node, leaf),
                        reduces=leaf in _SUM_DEFAULT))
                    prim_fns.add(key)
                    continue
                for leaf in self._fold_leaves(fi, node):
                    self.collective_sites.append(CollectiveSite(
                        "fold", key, fi.relpath, node, leaf,
                        operand=node.args[0] if node.args else None))
                    fold_fns.add(key)
        # callers, over resolved calls (local imports included)
        self._rev: Dict[str, Set[str]] = {}
        for key in self.cg.funcs:
            for _, targets in self.calls_of(key):
                for c in targets:
                    self._rev.setdefault(c, set()).add(key)
        # functions from which a cross-process collective is reachable
        self.process_collective_fns = self._backward(prim_fns)
        self.spmd_reachable: Set[str] = self._backward(prim_fns | fold_fns)
        # wrappers: the parameters their primitive takes its op and
        # operand from, read at the wrapper's call sites instead
        wrap: Dict[str, CollectiveSite] = {}
        for s in self.collective_sites:
            if s.kind == "process":
                wrap.setdefault(s.key, s)
        for key, fi in self.cg.funcs.items():
            for node, targets in self.calls_of(key):
                if self.is_process_collective(fi.module, node):
                    continue
                hit = [c for c in targets
                       if c in self.process_collective_fns and c != key]
                if not hit:
                    continue
                cfi = self.cg.funcs[hit[0]]
                bound = dict(self.bind_args(cfi, node))
                prim = wrap.get(hit[0])
                op = opnd = None
                if prim is not None:
                    params = set(_params(cfi.node))
                    op = prim.op
                    if isinstance(op, ast.Name) and op.id in params:
                        op = bound.get(op.id)
                    src = _param_source(cfi, prim.operand, params)
                    opnd = bound.get(src) if src else None
                self.collective_sites.append(CollectiveSite(
                    "process", key, fi.relpath, node,
                    _leaf(node.func) or cfi.name, operand=opnd, op=op,
                    reduces=prim is not None and prim.reduces,
                    via=hit[0]))
        self._rank_envs: Dict[Tuple[str, FrozenSet[str], FrozenSet[str]],
                              "RankEnv"] = {}
        self._proving: Set[Tuple] = set()
        self._invariant_params()

    def _backward(self, seeds: Set[str]) -> Set[str]:
        seen = set(seeds)
        stack = list(seeds)
        while stack:
            k = stack.pop()
            for c in self._rev.get(k, ()):
                if c not in seen:
                    seen.add(c)
                    stack.append(c)
        return seen

    def forwards_op(self, site: "CollectiveSite") -> bool:
        """A wrapper's own primitive whose op (or default-SUM operand) its
        callers pass in: checked at the wrapper's call sites."""
        fi = self.cg.funcs[site.key]
        return site.via is None and isinstance(site.op, ast.Name) \
            and site.op.id in _params(fi.node) \
            and bool(self._rev.get(site.key))

    # -- rank-invariance ------------------------------------------------------

    def declared_invariant(self, fi: cgmod.FuncInfo) -> Set[str]:
        out: Set[str] = set()
        node = fi.node
        for d in getattr(node, "decorator_list", ()):
            if isinstance(d, ast.Call) and _leaf(d.func) == "rank_invariant":
                out |= {a.value for a in d.args
                        if isinstance(a, ast.Constant)
                        and isinstance(a.value, str)}
        return out

    def _invariant_params(self) -> None:
        """Each collective-reaching function's rank-invariant parameters:
        its declaration, else the parameters every project call site
        binds to a rank-invariant value (a small fixpoint)."""
        self.rank_invariant: Dict[str, Set[str]] = {}
        fns = sorted(self.process_collective_fns)
        for k in fns:
            self.rank_invariant[k] = self.declared_invariant(self.cg.funcs[k])
        for _ in range(3):
            changed = False
            for k in fns:
                fi = self.cg.funcs[k]
                if self.declared_invariant(fi):
                    continue
                sites = [(c, n) for c in sorted(self._rev.get(k, ()))
                         for n, targets in self.calls_of(c) if k in targets]
                if not sites:
                    continue
                inv = None
                for c, call in sites:
                    env = self.rank_env(c)
                    got = {p for p, a in self.bind_args(fi, call)
                           if env.expr_inv(a)}
                    inv = got if inv is None else inv & got
                inv = inv or set()
                if inv != self.rank_invariant.get(k):
                    self.rank_invariant[k] = inv
                    changed = True
            if not changed:
                break

    def rank_env(self, key: str, inv_params: Optional[FrozenSet[str]] = None,
                 none_params: FrozenSet[str] = frozenset()) -> "RankEnv":
        if inv_params is None:
            inv_params = frozenset(self.rank_invariant.get(key, ()))
        ck = (key, inv_params, none_params)
        env = self._rank_envs.get(ck)
        if env is None:
            env = RankEnv(self, self.cg.funcs[key], inv_params, none_params)
            self._rank_envs[ck] = env
        return env

    # -- in-place writers -----------------------------------------------------

    def _discover_inplace(self) -> None:
        # func key -> the parameters whose storage it writes into
        self.inplace_writers: Dict[str, Set[str]] = {}
        for key, fi in self.cg.funcs.items():
            if isinstance(fi.node, ast.Lambda):
                continue
            params = set(_params(fi.node)) - {"self", "cls"}
            rebound = {t.id for n in own_nodes(fi.node)
                       if isinstance(n, (ast.Assign, ast.AugAssign,
                                         ast.AnnAssign))
                       for t in (n.targets if isinstance(n, ast.Assign)
                                 else [n.target])
                       if isinstance(t, ast.Name)}
            written: Set[str] = set()
            for n in own_nodes(fi.node):
                r = None
                if isinstance(n, ast.Call) \
                        and isinstance(n.func, ast.Attribute) \
                        and n.func.attr in INPLACE_WRITES:
                    r = root_name(n.func.value)
                elif isinstance(n, (ast.Assign, ast.AugAssign)):
                    for t in (n.targets if isinstance(n, ast.Assign)
                              else [n.target]):
                        if isinstance(t, ast.Subscript) \
                                and _slices(t.slice):
                            r = root_name(t.value)
                if r in params and r not in rebound:
                    written.add(r)
            if written:
                self.inplace_writers[key] = written
        self.inplace_calls: List[InplaceCall] = []
        for key, fi in self.cg.funcs.items():
            for node, targets in self.calls_of(key):
                for w in targets:
                    if w not in self.inplace_writers or w == key:
                        continue
                    wfi = self.cg.funcs[w]
                    written = [a for p, a in self.bind_args(wfi, node)
                               if p in self.inplace_writers[w]]
                    if written:
                        self.inplace_calls.append(InplaceCall(
                            key, fi.relpath, node, w, written))
                    break


# -- SPMD: collectives, rank-invariance, in-place writers ---------------------

# cross-process collectives of torch.distributed: every rank of the group
# must reach the same sequence of them, or the group hangs
PROCESS_COLLECTIVES = frozenset({
    "all_reduce", "all_gather", "all_gather_into_tensor",
    "all_gather_object", "broadcast", "broadcast_object_list", "reduce",
    "reduce_scatter", "reduce_scatter_tensor", "all_to_all",
    "all_to_all_single", "barrier", "gather", "scatter",
})
# the collectives that reduce, with ReduceOp.SUM unless told otherwise
_SUM_DEFAULT = frozenset({"all_reduce", "reduce", "reduce_scatter",
                          "reduce_scatter_tensor"})
# in-process partition folds (parallel/mesh.py): one process combines its
# partitions' partials in partition order
PARTITION_FOLDS = frozenset({"psum", "pmin", "pmax", "pmean", "all_gather"})
# reads that differ between ranks by construction
RANK_DIVERGENT_LEAVES = frozenset({
    "get_rank", "get_node_local_rank", "getpid", "gethostname", "urandom",
    "getenv", "uuid4", "time", "time_ns", "monotonic", "perf_counter",
    "random", "randint", "choice", "shuffle", "rand", "randn", "uniform",
    "normal", "environ",
})
# builtins that never return None
_NEVER_NONE = frozenset({
    "int", "float", "bool", "str", "len", "list", "tuple", "dict", "set",
    "sorted", "range", "min", "max", "sum", "abs", "round", "repr",
})
# tensor methods that write into their receiver's storage
INPLACE_WRITES = frozenset({
    "copy_", "index_copy_", "index_put_", "index_fill_", "masked_fill_",
    "scatter_", "scatter_add_", "scatter_reduce_", "fill_", "zero_",
})
# tensor methods and attributes whose result may share the storage
VIEW_METHODS = frozenset({
    "view", "view_as", "narrow", "select", "expand", "expand_as",
    "transpose", "permute", "t", "unsqueeze", "squeeze", "unflatten",
    "diagonal", "as_strided", "split", "chunk", "unbind", "detach",
    "movedim", "swapaxes", "unfold", "reshape", "flatten", "contiguous",
})
VIEW_ATTRS = frozenset({"T", "mT", "H", "mH", "real", "imag", "data"})


@dataclass
class CollectiveSite:
    """One collective call inside a function body."""
    kind: str                   # process | fold
    key: str                    # the enclosing function
    relpath: str
    call: ast.Call
    name: str                   # all_reduce / _all_reduce / psum ...
    operand: Optional[ast.AST] = None
    op: Optional[ast.AST] = None    # the reduction op (None: the default)
    reduces: bool = False       # a reduction (SUM unless ``op`` says)
    via: Optional[str] = None   # the project wrapper's key


@dataclass
class InplaceCall:
    """One call of an in-place writer, with the arguments it writes."""
    key: str                    # the caller
    relpath: str
    call: ast.Call
    writer: str                 # the writer's key
    written: List[ast.AST]


def root_name(e) -> Optional[str]:
    """The name an attribute/subscript chain hangs off (``p`` for
    ``p[a:b].data``), or None."""
    while isinstance(e, (ast.Subscript, ast.Attribute)):
        e = e.value
    return e.id if isinstance(e, ast.Name) else None


def _slices(e) -> bool:
    """A subscript that takes a slice or ``...`` (storage, not a key)."""
    return any(isinstance(n, ast.Slice) or (isinstance(n, ast.Constant)
                                             and n.value is Ellipsis)
               for n in ast.walk(e))


def _dist_names(tree: ast.Module) -> Tuple[Set[str], Set[str]]:
    """(names bound to ``torch.distributed``, collective names imported
    from it) anywhere in a module, function-local imports included."""
    aliases: Set[str] = set()
    names: Set[str] = set()
    for node in walk_nodes(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "torch.distributed" and a.asname:
                    aliases.add(a.asname)
        elif isinstance(node, ast.ImportFrom):
            for a in node.names:
                if node.module == "torch" and a.name == "distributed":
                    aliases.add(a.asname or a.name)
                elif node.module == "torch.distributed" \
                        and a.name in PROCESS_COLLECTIVES:
                    names.add(a.asname or a.name)
    return aliases, names


def _op_arg(call: ast.Call, leaf: str) -> Optional[ast.AST]:
    for kw in call.keywords:
        if kw.arg == "op":
            return kw.value
    pos = {"all_reduce": 1, "reduce": 2, "reduce_scatter": 2,
           "reduce_scatter_tensor": 2}.get(leaf)
    if pos is not None and len(call.args) > pos:
        return call.args[pos]
    return None


def _param_source(fi: cgmod.FuncInfo, expr, params: Set[str]
                  ) -> Optional[str]:
    """The parameter a collective's operand is, or is computed from by one
    local assignment of a method chain (``buf = t.to(dev).contiguous()``),
    or None."""
    if not isinstance(expr, ast.Name):
        return None
    if expr.id in params:
        return expr.id
    for node in own_nodes(fi.node):
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == expr.id
                for t in node.targets):
            e = node.value
            while isinstance(e, ast.Call) \
                    and isinstance(e.func, ast.Attribute):
                e = e.func.value
            if root_name(e) in params:
                return root_name(e)
    return None


class RankEnv:
    """Rank-invariance inside one function: which local values hold the
    same on every rank (``inv``), given the parameters that do
    (``inv_params``) and those whose None-ness does (``none_params``).

    Flow-insensitive over the function's own body: a local is invariant
    when every assignment to it is, under control tests that are. For
    None-ness only the ``if``/``while`` tests count, not a loop's trip
    count: an assignment inside a loop is taken to be read in the same
    iteration (``x = None; for p in ps: x = p`` read after the loop is a
    blind spot), and a container's element None-ness follows what is
    appended or stored into it."""

    def __init__(self, df: "DeviceDataflow", fi: cgmod.FuncInfo,
                 inv_params: FrozenSet[str], none_params: FrozenSet[str]):
        self.df, self.fi = df, fi
        self.params = set(_params(fi.node))
        self.none_params = set(none_params) | set(inv_params)
        # name -> [(kind, value, control context)]
        self.defs: Dict[str, List[Tuple[str, object, Tuple]]] = {}
        self.returns: List[Tuple[ast.Return, Tuple]] = []
        self.fixed: Set[str] = set()        # imports, nested defs
        body = fi.node.body
        if isinstance(fi.node, ast.Lambda):
            self.returns.append((ast.Return(value=body), ()))
        else:
            for stmt in body:
                self._collect(stmt, ())
        self.locals = self.params | set(self.defs) | self.fixed
        self.inv: Set[str] = set(inv_params) | self.fixed
        changed = True
        while changed:
            changed = False
            for name, defs in self.defs.items():
                if name in self.inv or name in self.params:
                    continue
                if all(self._def_inv(d) for d in defs):
                    self.inv.add(name)
                    changed = True

    # -- collection ---------------------------------------------------------

    def _def(self, name: str, kind: str, value, ctx) -> None:
        self.defs.setdefault(name, []).append((kind, value, ctx))

    def _targets(self, t, kind, value, ctx) -> None:
        if isinstance(t, ast.Name):
            self._def(t.id, kind, value, ctx)
        elif isinstance(t, (ast.Tuple, ast.List)):
            for i, el in enumerate(t.elts):
                if isinstance(el, ast.Name):
                    self._def(el.id, "unpack" if kind == "assign" else kind,
                              (value, i) if kind == "assign" else value, ctx)
                elif isinstance(el, ast.Starred) \
                        and isinstance(el.value, ast.Name):
                    self._def(el.value.id, "unknown", None, ctx)
        elif isinstance(t, ast.Subscript):
            r = root_name(t.value)
            if r is not None:
                self._def(r, "elem", value, ctx)

    def _collect(self, node, ctx: Tuple) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            self.fixed.add(node.name)
            return
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            for a in node.names:
                self.fixed.add(a.asname or a.name.split(".")[0])
            return
        if isinstance(node, ast.Return):
            self.returns.append((node, ctx))
            return
        if isinstance(node, ast.Assign):
            for t in node.targets:
                self._targets(t, "assign", node.value, ctx)
            return
        if isinstance(node, ast.AugAssign):
            self._targets(node.target, "assign", ast.BinOp(
                left=node.target, op=node.op, right=node.value), ctx)
            return
        if isinstance(node, ast.AnnAssign) and node.value is not None:
            self._targets(node.target, "assign", node.value, ctx)
            return
        if isinstance(node, ast.Expr) and isinstance(node.value, ast.Call):
            f = node.value.func
            if isinstance(f, ast.Attribute) \
                    and f.attr in ("append", "extend", "insert", "add") \
                    and isinstance(f.value, ast.Name) and node.value.args:
                self._def(f.value.id, "elem" if f.attr != "extend"
                          else "iter", node.value.args[-1], ctx)
            return
        if isinstance(node, (ast.For, ast.AsyncFor)):
            self._targets(node.target, "iter", node.iter, ctx)
            inner = ctx + (("for", node.iter),)
            for s in node.body + node.orelse:
                self._collect(s, inner)
            return
        if isinstance(node, (ast.If, ast.While)):
            inner = ctx + (("if", node.test),)
            for s in node.body + node.orelse:
                self._collect(s, inner)
            return
        if isinstance(node, (ast.With, ast.AsyncWith)):
            for it in node.items:
                if it.optional_vars is not None:
                    self._targets(it.optional_vars, "assign",
                                  it.context_expr, ctx)
            for s in node.body:
                self._collect(s, ctx)
            return
        if isinstance(node, ast.Try):
            for h in node.handlers:
                if h.name:
                    self._def(h.name, "unknown", None, ctx)
                for s in h.body:
                    self._collect(s, ctx)
            for s in node.body + node.orelse + node.finalbody:
                self._collect(s, ctx)

    # -- invariance -----------------------------------------------------------

    def _ctx_inv(self, ctx, none_only: bool = False) -> bool:
        for kind, e in ctx:
            if kind == "for":
                if not none_only and not self.expr_inv(e):
                    return False
            elif not self.test_inv(e):
                return False
        return True

    def _def_inv(self, d) -> bool:
        kind, value, ctx = d
        if kind == "unknown" or not self._ctx_inv(ctx):
            return False
        if kind == "unpack":
            return self.expr_inv(value[0])
        return self.expr_inv(value)

    def is_collective_call(self, e: ast.Call) -> bool:
        if self.df.is_process_collective(self.fi.module, e):
            return True
        return any(c in self.df.process_collective_fns
                   for c in self.df.call_targets(self.fi, e))

    def expr_inv(self, e) -> bool:
        """``e`` evaluates alike on every rank."""
        if e is None or isinstance(e, ast.Constant):
            return True
        if isinstance(e, ast.Name):
            if e.id in self.inv:
                return True
            return e.id not in self.locals
        if isinstance(e, ast.Attribute):
            return e.attr not in RANK_DIVERGENT_LEAVES \
                and self.expr_inv(e.value)
        if isinstance(e, ast.Subscript):
            return self.expr_inv(e.value) and self.expr_inv(e.slice)
        if isinstance(e, ast.Call):
            if self.is_collective_call(e):
                return True         # what the group agreed on
            d = _dotted(e.func) or ""
            parts = d.split(".")
            if parts[-1] in RANK_DIVERGENT_LEAVES or "random" in parts[:-1]:
                return False
            return self.expr_inv(e.func) and all(
                self.expr_inv(a) for a in e.args) and all(
                self.expr_inv(kw.value) for kw in e.keywords)
        if isinstance(e, (ast.BinOp, ast.UnaryOp, ast.BoolOp, ast.Compare,
                          ast.IfExp, ast.Tuple, ast.List, ast.Set,
                          ast.Dict, ast.JoinedStr, ast.FormattedValue,
                          ast.Starred, ast.Slice, ast.keyword)):
            return all(self.expr_inv(c) for c in ast.iter_child_nodes(e)
                       if not isinstance(c, (ast.operator, ast.unaryop,
                                             ast.boolop, ast.cmpop,
                                             ast.expr_context)))
        return False

    def test_inv(self, t) -> bool:
        """A control test takes the same branch on every rank."""
        if isinstance(t, ast.BoolOp):
            return all(self.test_inv(v) for v in t.values)
        if isinstance(t, ast.UnaryOp) and isinstance(t.op, ast.Not):
            return self.test_inv(t.operand)
        if isinstance(t, ast.Compare) and len(t.ops) == 1 \
                and isinstance(t.ops[0], (ast.Is, ast.IsNot)):
            a, b = t.left, t.comparators[0]
            if isinstance(b, ast.Constant) and b.value is None:
                return self.none_inv(a)
            if isinstance(a, ast.Constant) and a.value is None:
                return self.none_inv(b)
        return self.expr_inv(t)

    # -- None-ness ----------------------------------------------------------

    def none_inv(self, e, _seen: Optional[Set[str]] = None) -> bool:
        """Whether ``e`` is None is the same on every rank."""
        seen = _seen if _seen is not None else set()
        if isinstance(e, ast.Constant):
            return True
        if isinstance(e, ast.Name):
            if e.id in self.inv or e.id in self.none_params \
                    or e.id in seen:
                return True
            if e.id in self.params:
                return False
            if e.id not in self.locals:
                return True
            seen.add(e.id)
            return all(self._def_none(d, seen)
                       for d in self.defs.get(e.id, ()))
        if isinstance(e, ast.Subscript):
            return self.none_inv(e.value, seen)
        if isinstance(e, ast.Call):
            return self.call_none(e, None)
        if isinstance(e, ast.IfExp):
            return self.test_inv(e.test) and self.none_inv(e.body, seen) \
                and self.none_inv(e.orelse, seen)
        if isinstance(e, ast.BoolOp):
            return all(self.none_inv(v, seen) for v in e.values)
        return isinstance(e, (ast.BinOp, ast.UnaryOp, ast.Compare,
                              ast.List, ast.Tuple, ast.Set, ast.Dict,
                              ast.ListComp, ast.SetComp, ast.DictComp,
                              ast.GeneratorExp, ast.JoinedStr, ast.Lambda))

    def _def_none(self, d, seen) -> bool:
        kind, value, ctx = d
        if kind == "unknown" or not self._ctx_inv(ctx, none_only=True):
            return False
        if kind == "unpack":
            v, i = value
            if isinstance(v, (ast.Tuple, ast.List)) and i < len(v.elts):
                return self.none_inv(v.elts[i], seen)
            return isinstance(v, ast.Call) and self.call_none(v, i)
        return self.none_inv(value, seen)

    def call_none(self, call: ast.Call, pos: Optional[int]) -> bool:
        """Whether the call's result (its ``pos``-th element) is None is
        the same on every rank: a project function's returns under its
        arguments' invariance; a library call never returns None."""
        df = self.df
        targets = df.call_targets(self.fi, call)
        if not targets:
            if pos is not None:
                return False
            d = _dotted(call.func) or ""
            if d.split(".", 1)[0] in ("torch", "np", "numpy", "math"):
                return True
            if isinstance(call.func, ast.Name):
                return call.func.id in _NEVER_NONE
            return isinstance(call.func, ast.Attribute) \
                and call.func.attr in _HOST_META | HOST_PULLS | {
                    "to", "clone", "contiguous", "float", "double", "int",
                    "long", "sum", "cumsum"}
        for k in targets:
            cfi = df.cg.funcs.get(k)
            if cfi is None or isinstance(cfi.node, ast.Lambda):
                return False
            inv, none = set(), set()
            for p, a in df.bind_args(cfi, call):
                if self.expr_inv(a):
                    inv.add(p)
                elif self.none_inv(a):
                    none.add(p)
            proof = (k, frozenset(inv), frozenset(none), pos)
            if proof in df._proving:
                return False
            df._proving.add(proof)
            try:
                ok = df.rank_env(k, frozenset(inv),
                                 frozenset(none)).returns_none_inv(pos)
            finally:
                df._proving.discard(proof)
            if not ok:
                return False
        return True

    def returns_none_inv(self, pos: Optional[int]) -> bool:
        for ret, ctx in self.returns:
            if not self._ctx_inv(ctx, none_only=True):
                return False
            v = ret.value
            if v is None or (isinstance(v, ast.Constant) and v.value is None):
                continue
            if pos is not None:
                if isinstance(v, ast.Tuple):
                    if pos >= len(v.elts) or not self.none_inv(v.elts[pos]):
                        return False
                elif not (isinstance(v, ast.Call) and self.call_none(v, pos)):
                    return False
            elif not self.none_inv(v):
                return False
        return True


def build(mods: Sequence[ModuleSource],
          cg: Optional[cgmod.CallGraph] = None) -> DeviceDataflow:
    if cg is None:
        cg = cgmod.build(mods)
    return DeviceDataflow(mods, cg)
