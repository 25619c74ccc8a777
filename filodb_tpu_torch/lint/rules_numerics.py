"""Numeric-precision and determinism rules of the port (counterpart of
the reference's ``rules_numerics``).

Built on :mod:`filodb_tpu_torch.lint.dataflow` with a local torch dtype
inference: every assignment in a scanned function is classified into
{f64, f32, f16, i64, i32, bool, neutral, unknown} from explicit dtypes
(``dtype=`` keywords; ``.to(dtype)``, ``.to(device, dtype)``,
``.to(dtype=...)``; ``.float()``/``.double()``/``.half()``/``.int()``/
``.long()``; ``.type(torch.X)``; numpy's ``astype`` and ``np.float32(x)``;
module aliases such as ``F32 = torch.float32``) and propagation through
arithmetic (the widest operand wins; an integer tensor divided, or mixed
with a Python float, is unknown, since torch then takes its default
float dtype; anything touching an unknown stays unknown), so the rules
fire on provable facts only.

Scope: eager PyTorch has no traced set, so the rules scan the functions
where the dataflow holds a device tensor (``device_fns``), the
``torch.func.vmap`` bodies (``traced``), the functions that reach a
collective (``spmd_reachable``), and every function carrying
``@precision`` or ``@order_insensitive``, with their lexical children.

  * ``precision-narrowing`` — an f64/i64 value cast to f32, f16 or i32
    in a scanned function with no ``@precision(bits=..., reason=...)``
    on itself or a lexical ancestor.
  * ``accumulation-bound`` — ``torch.sum``/``.sum()``/``nansum``/
    ``cumsum``/``.cumsum()``/``matmul``/``@``/``mm``/``bmm``/``einsum``/
    ``index_add_``/``scatter_add_`` accumulating in f32 or f16: the
    function needs ``@precision(accum_terms=N)`` with ``N <=
    2**mantissa``, or ``compensated=True``, or must accumulate in f64
    (``dtype=``).
  * ``reduction-order-determinism`` — a float (or unprovable) ``psum``
    partition fold, or a reducing ``torch.distributed`` collective whose
    op is SUM (the default) or not provably MIN/MAX, in
    ``spmd_reachable`` code without ``@order_insensitive``: its grouping
    follows the partition or rank count. Integer, bool and literal
    operands are exempt, as are ``pmin``/``pmax``. A wrapper that
    forwards its op (``_all_reduce(t, op)``) is checked at its call
    sites.
  * ``mixed-dtype-comparison`` — a comparison mixing f32 and f64, or
    comparing a float cast of a provably-integer value, in the plain
    PyTorch version of a CUDA kernel (the ``plain=`` of a
    ``kind="cuda"`` contract): the kernel is held to it, and such a
    branch can flip between the two. The kernels' own bodies are ``.cu``
    files that no Python rule parses; they are outside this rule.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Sequence, Set, Tuple

from filodb_tpu_torch.lint import Finding, ModuleSource, register_rule
from filodb_tpu_torch.lint import callgraph as cgmod
from filodb_tpu_torch.lint import dataflow as dfmod

register_rule("precision-narrowing", "numerics",
              "f64/int64 value flows into an f32/int32 op without a "
              "@precision(bits=..., reason=...) annotation")
register_rule("accumulation-bound", "numerics",
              "f32 accumulation without a static term bound under the "
              "mantissa (2**24) or a compensated/f64-accumulate marker")
register_rule("reduction-order-determinism", "numerics",
              "partition- or rank-count-dependent float reduction (psum "
              "fold, SUM all-reduce) without @order_insensitive("
              "tolerance=...) and not provably integer/exact")
register_rule("mixed-dtype-comparison", "numerics",
              "f32/f64-mixed or int-cast-to-float comparison in a CUDA "
              "kernel's plain version — the branch can differ between "
              "the kernel and its plain version")

# dtype classes
F64, F32, F16, I64, I32, BOOL, NEUTRAL = \
    "f64", "f32", "f16", "i64", "i32", "bool", "neutral"
NEUTRAL_F = "neutral-float"     # a Python float: no tensor dtype of its own

_DTYPE_LEAVES = {
    "float64": F64, "double": F64,
    "float32": F32,
    "float16": F16, "bfloat16": F16, "half": F16,
    "int64": I64, "uint64": I64, "long": I64,
    "int32": I32, "uint32": I32, "int8": I32, "uint8": I32,
    "int16": I32, "uint16": I32, "short": I32,
    "bool_": BOOL,
}
# torch.float / torch.int / torch.bool: dtypes only under ``torch.``
_TORCH_ONLY = {"float": F32, "int": I32, "bool": BOOL}
# tensor methods casting their receiver
_CAST_METHODS = {"float": F32, "double": F64, "half": F16,
                 "bfloat16": F16, "int": I32, "long": I64, "short": I32,
                 "char": I32, "byte": I32, "bool": BOOL}

_FLOATS = {F64, F32, F16}
_INTS = {I64, I32}
_WIDE = {F64, I64}
_NARROW_FLOAT = {F32, F16}

_MANTISSA = {F32: 24, F16: 11, F64: 53}

# reductions whose accumulator the accumulation-bound family budgets
_ACCUM_LEAVES = {"sum", "nansum", "cumsum", "matmul", "mm", "bmm",
                 "einsum", "index_add_", "scatter_add_", "index_add",
                 "scatter_add"}
# functions and methods whose result has their first operand's dtype
_FOLLOW_FIRST = {
    "abs", "neg", "floor", "ceil", "round", "trunc", "clamp", "clip",
    "clamp_min", "clamp_max", "index_select", "gather", "take", "reshape",
    "view", "transpose", "permute", "flatten", "unsqueeze", "squeeze",
    "expand", "expand_as", "contiguous", "clone", "detach", "flip",
    "roll", "narrow", "select", "repeat", "repeat_interleave", "t",
    "cummax", "cummin", "amax", "amin", "diff", "sort", "nan_to_num",
    "fmod", "remainder", "square", "sqrt", "exp", "log", "relu",
}
# functions whose result has their operands' widest dtype
_FOLLOW_ALL = {"where", "minimum", "maximum", "fmin", "fmax", "cat",
               "stack", "concat", "concatenate", "hstack", "vstack"}
_BOOL_FNS = {"isnan", "isfinite", "isinf", "logical_and", "logical_or",
             "logical_not", "eq", "ne", "lt", "le", "gt", "ge", "any",
             "all", "isclose", "isin", "signbit"}


def _dtype_class_of_expr(expr, aliases: Dict[str, str]) -> Optional[str]:
    """Dtype class named by a dtype-position expression (``torch.float32``,
    ``np.int64``, a module alias ``F32``, a 'float32' string)."""
    if isinstance(expr, ast.Attribute):
        if expr.attr in _DTYPE_LEAVES:
            return _DTYPE_LEAVES[expr.attr]
        if expr.attr in _TORCH_ONLY and dfmod._dotted(expr.value) == "torch":
            return _TORCH_ONLY[expr.attr]
        return None
    if isinstance(expr, ast.Name):
        return aliases.get(expr.id)
    if isinstance(expr, ast.Constant) and isinstance(expr.value, str):
        return _DTYPE_LEAVES.get(expr.value)
    return None


def _widest(classes: Sequence[Optional[str]]) -> Optional[str]:
    """Widest dtype class of operands under torch's promotion; None
    (unknown) dominates, so the rules never fire on an inference gap."""
    real = [c for c in classes if c not in (NEUTRAL, NEUTRAL_F)]
    if any(c is None for c in real):
        return None
    if not real:
        return NEUTRAL_F if NEUTRAL_F in classes else NEUTRAL
    floats = [c for c in real if c in _FLOATS]
    if floats:
        for c in (F64, F32, F16):
            if c in floats:
                return c
    if NEUTRAL_F in classes:
        return None         # an integer tensor with a Python float
    ints = [c for c in real if c in _INTS]
    if ints:
        return I64 if I64 in ints else I32
    return real[0]


def _dtype_kw(call: ast.Call, aliases) -> Optional[str]:
    for kw in call.keywords:
        if kw.arg == "dtype":
            return _dtype_class_of_expr(kw.value, aliases)
    return None


class _DtypeEnv:
    """Per-function dtype-class environment: two passes over the
    assignments in source order reach a fixpoint for the straight-line
    channel math the evaluators are made of."""

    def __init__(self, fn_node, aliases: Dict[str, str]):
        self.aliases = dict(aliases)
        self.env: Dict[str, Optional[str]] = {}
        # names holding a float cast of a provably-integer value
        self.float_from_int: Set[str] = set()
        nodes = dfmod.own_nodes(fn_node)
        for node in nodes:
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name) \
                    and isinstance(node.value, ast.Attribute):
                cls = _dtype_class_of_expr(node.value, self.aliases)
                if cls is not None:
                    self.aliases[node.targets[0].id] = cls
        assigns = sorted((n for n in nodes
                          if isinstance(n, (ast.Assign, ast.AugAssign))),
                         key=lambda n: (n.lineno, n.col_offset))
        for _ in range(2):
            for node in assigns:
                if isinstance(node, ast.Assign):
                    cls = self.classify(node.value)
                    tainted = self.is_int_float_cast(node.value)
                    for t in node.targets:
                        if isinstance(t, ast.Name):
                            self.env[t.id] = cls
                            if tainted:
                                self.float_from_int.add(t.id)
                            else:
                                self.float_from_int.discard(t.id)
                        elif isinstance(t, (ast.Tuple, ast.List)):
                            vals = node.value.elts if isinstance(
                                node.value, (ast.Tuple, ast.List)) \
                                and len(node.value.elts) == len(t.elts) \
                                else None
                            for i, el in enumerate(t.elts):
                                if isinstance(el, ast.Name):
                                    self.env[el.id] = self.classify(
                                        vals[i]) if vals else None
                elif isinstance(node.target, ast.Name):
                    self.env[node.target.id] = _widest(
                        [self.env.get(node.target.id),
                         self.classify(node.value)])

    # -- classification ----------------------------------------------------
    def classify(self, e) -> Optional[str]:
        if isinstance(e, ast.Constant):
            v = e.value
            if isinstance(v, bool):
                return BOOL
            if isinstance(v, int):
                return NEUTRAL
            if isinstance(v, float):
                return NEUTRAL_F
            return None
        if isinstance(e, ast.Name):
            return self.env.get(e.id)
        if isinstance(e, ast.UnaryOp):
            if isinstance(e.op, ast.Not):
                return BOOL
            return self.classify(e.operand)
        if isinstance(e, (ast.Compare, ast.BoolOp)):
            return BOOL
        if isinstance(e, ast.BinOp):
            if isinstance(e.op, ast.MatMult):
                return _widest([self.classify(e.left),
                                self.classify(e.right)])
            cls = _widest([self.classify(e.left), self.classify(e.right)])
            if isinstance(e.op, ast.Div) and cls in _INTS | {NEUTRAL}:
                return None     # true division: the default float dtype
            return cls
        if isinstance(e, ast.IfExp):
            return _widest([self.classify(e.body), self.classify(e.orelse)])
        if isinstance(e, ast.Subscript):
            return self.classify(e.value)
        if isinstance(e, ast.Attribute):
            if e.attr in ("T", "mT", "data"):
                return self.classify(e.value)
            return None
        if isinstance(e, ast.Call):
            return self._classify_call(e)
        if isinstance(e, (ast.List, ast.Tuple)) and e.elts:
            return _widest([self.classify(x) for x in e.elts])
        if isinstance(e, (ast.ListComp, ast.GeneratorExp)):
            return self.classify(e.elt)
        return None

    def _classify_call(self, e: ast.Call) -> Optional[str]:
        cast = self.cast_site(e)
        if cast is not None:
            return cast[0]
        f = e.func
        leaf = dfmod._leaf(f)
        kw = _dtype_kw(e, self.aliases)
        if kw is not None:
            return kw
        if isinstance(f, ast.Name):
            if f.id == "float":
                return NEUTRAL_F
            if f.id in ("int", "len"):
                return NEUTRAL
            if f.id == "bool":
                return BOOL
        d = dfmod._dotted(f) or ""
        base = d.split(".", 1)[0]
        is_fn = base in ("torch", "np", "numpy", "F")
        if leaf in _BOOL_FNS:
            return BOOL
        if leaf in ("full", "full_like") and is_fn and len(e.args) >= 2:
            return None         # the default dtype of its fill value
        if leaf in ("zeros_like", "ones_like", "empty_like") and e.args:
            return self.classify(e.args[0])
        if leaf in _FOLLOW_ALL:
            args = e.args[1:3] if leaf == "where" else e.args
            if leaf in ("cat", "stack", "concat", "concatenate", "hstack",
                        "vstack") and args \
                    and isinstance(args[0], (ast.List, ast.Tuple)):
                args = args[0].elts
            return _widest([self.classify(a) for a in args] or [None])
        if leaf in _FOLLOW_FIRST or leaf in ("sum", "cumsum", "nansum",
                                             "matmul", "mm", "bmm"):
            src = e.args[0] if is_fn and e.args else (
                f.value if isinstance(f, ast.Attribute) else None)
            if src is None:
                return None
            cls = self.classify(src)
            if leaf in ("sum", "cumsum", "nansum") and cls in _INTS | {BOOL}:
                return I64      # torch sums integers in int64
            if leaf in ("matmul", "mm", "bmm") and is_fn and len(e.args) > 1:
                return _widest([cls, self.classify(e.args[1])])
            return cls
        if leaf == "arange" and is_fn:
            if any(isinstance(a, ast.Constant) and isinstance(a.value, float)
                   for a in e.args):
                return None
            return I64 if all(self.classify(a) in (NEUTRAL, I64, I32)
                              for a in e.args) and e.args else None
        return None

    def is_int_float_cast(self, e) -> bool:
        """``e`` is (or names) a float cast of a provably-int value."""
        if isinstance(e, ast.Name):
            return e.id in self.float_from_int
        if isinstance(e, ast.BinOp) and isinstance(
                e.op, (ast.Mult, ast.Add, ast.Sub)):
            return self.is_int_float_cast(e.left) \
                or self.is_int_float_cast(e.right)
        if isinstance(e, ast.Call):
            cast = self.cast_site(e)
            return cast is not None and cast[0] in _FLOATS \
                and cast[1] in _INTS
        return False

    # -- cast-site detection -------------------------------------------
    def cast_site(self, e: ast.Call
                  ) -> Optional[Tuple[str, Optional[str], ast.AST]]:
        """(target class, operand class, operand expr) when ``e`` is a
        dtype cast, else None."""
        f = e.func
        leaf = dfmod._leaf(f)
        if isinstance(f, ast.Attribute):
            recv = f.value
            tgt = None
            if leaf == "to":
                tgt = _dtype_kw(e, self.aliases)
                for a in e.args[:2]:
                    tgt = tgt or _dtype_class_of_expr(a, self.aliases)
            elif leaf in ("astype", "type") and e.args:
                tgt = _dtype_class_of_expr(e.args[0], self.aliases)
            elif leaf in _CAST_METHODS and not e.args and not e.keywords \
                    and dfmod._dotted(recv) not in ("torch", "np", "numpy"):
                tgt = _CAST_METHODS[leaf]
            if tgt is not None:
                return tgt, self.classify(recv), recv
            # constructor form np.float32(x)
            if leaf in _DTYPE_LEAVES and len(e.args) == 1 \
                    and not e.keywords \
                    and dfmod._dotted(recv) in ("np", "numpy"):
                return _DTYPE_LEAVES[leaf], self.classify(e.args[0]), \
                    e.args[0]
            return None
        if isinstance(f, ast.Name) and f.id in self.aliases \
                and len(e.args) == 1:
            return self.aliases[f.id], self.classify(e.args[0]), e.args[0]
        return None


# -- annotation discovery ----------------------------------------------------


def _int_const(e) -> Optional[int]:
    """Tiny constant folder for annotation kwargs (2**24, 1 << 20)."""
    if isinstance(e, ast.Constant) and isinstance(e.value, int) \
            and not isinstance(e.value, bool):
        return e.value
    if isinstance(e, ast.BinOp):
        l, r = _int_const(e.left), _int_const(e.right)
        if l is None or r is None:
            return None
        try:
            if isinstance(e.op, ast.Pow):
                return l ** r
            if isinstance(e.op, ast.LShift):
                return l << r
            if isinstance(e.op, ast.Mult):
                return l * r
            if isinstance(e.op, ast.Add):
                return l + r
            if isinstance(e.op, ast.Sub):
                return l - r
        except (OverflowError, ValueError):
            return None
    if isinstance(e, ast.UnaryOp) and isinstance(e.op, ast.USub):
        v = _int_const(e.operand)
        return -v if v is not None else None
    return None


class _Annotations:
    """@precision / @order_insensitive decorators per function key, with
    parsed static kwargs."""

    def __init__(self, cg: cgmod.CallGraph):
        self.precision: Dict[str, Dict[str, object]] = {}
        self.order: Set[str] = set()
        for key, fi in cg.funcs.items():
            node = fi.node
            if isinstance(node, ast.Lambda):
                continue
            for d in node.decorator_list:
                call = d if isinstance(d, ast.Call) else None
                leaf = dfmod._leaf(call.func if call else d)
                if leaf == "precision":
                    info: Dict[str, object] = {}
                    for kw in (call.keywords if call else ()):
                        if kw.arg == "accum_terms":
                            info["accum_terms"] = _int_const(kw.value)
                        elif kw.arg == "compensated":
                            info["compensated"] = (
                                isinstance(kw.value, ast.Constant)
                                and kw.value.value is True)
                        elif kw.arg == "bits":
                            info["bits"] = _int_const(kw.value)
                    self.precision[key] = info
                elif leaf == "order_insensitive":
                    self.order.add(key)

    @staticmethod
    def ancestors(cg: cgmod.CallGraph, key: str) -> List[str]:
        out = [key]
        fi = cg.funcs.get(key)
        if fi is None:
            return out
        qual = fi.qualname
        while ".<locals>." in qual:
            qual = qual.rsplit(".<locals>.", 1)[0]
            out.append(f"{fi.module}:{qual}")
        return out

    def precision_for(self, cg, key: str) -> Optional[Dict[str, object]]:
        for k in self.ancestors(cg, key):
            if k in self.precision:
                return self.precision[k]
        return None

    def order_for(self, cg, key: str) -> bool:
        return any(k in self.order for k in self.ancestors(cg, key))


def _module_aliases(mod: ModuleSource) -> Dict[str, str]:
    """Module-level dtype aliases (``F32 = torch.float32``)."""
    out: Dict[str, str] = {}
    for node in mod.tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            cls = _dtype_class_of_expr(node.value, {}) \
                if isinstance(node.value, ast.Attribute) else None
            if cls is not None:
                out[node.targets[0].id] = cls
    return out


def _plain_versions(df: dfmod.DeviceDataflow) -> Set[str]:
    """The plain PyTorch versions of the CUDA kernels (``plain=`` of a
    ``kind="cuda"`` contract), with their lexical children."""
    out: Set[str] = set()
    for fi in df.cg.funcs.values():
        if isinstance(fi.node, ast.Lambda):
            continue
        for d in fi.node.decorator_list:
            if not (isinstance(d, ast.Call)
                    and dfmod._leaf(d.func) == "kernel_contract"):
                continue
            kws = {kw.arg: kw.value for kw in d.keywords}
            kind = kws.get("kind")
            if not (isinstance(kind, ast.Constant) and kind.value == "cuda"):
                continue
            plain = kws.get("plain")
            if isinstance(plain, ast.Name):
                k = df.resolve_name(fi, plain.id)
                if k is not None:
                    out |= {k} | _lexical_closure(df, k)
    return out


def _lexical_closure(df: dfmod.DeviceDataflow, key: str) -> Set[str]:
    out: Set[str] = set()
    stack = [key]
    while stack:
        for k in df._lexical_children.get(stack.pop(), ()):
            if k not in out:
                out.add(k)
                stack.append(k)
    return out


# -- the families ------------------------------------------------------------


def _accum_site(node, env: _DtypeEnv
                ) -> Optional[Tuple[Optional[str], str]]:
    """(accumulator dtype class, label) when ``node`` accumulates; None
    otherwise. A ``dtype=`` on the reduction is the accumulator (the f64
    escape)."""
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.MatMult):
        return _widest([env.classify(node.left),
                        env.classify(node.right)]), "matmul(@)"
    if not isinstance(node, ast.Call):
        return None
    f = node.func
    leaf = dfmod._leaf(f)
    if leaf not in _ACCUM_LEAVES:
        return None
    d = dfmod._dotted(f) or ""
    is_fn = d.split(".", 1)[0] in ("torch", "np", "numpy") and "." in d
    kw = _dtype_kw(node, env.aliases)
    if kw is not None:
        return kw, f"{leaf}()"
    if is_fn:
        if leaf == "einsum":
            ops = node.args[1:]
        elif leaf in ("matmul", "mm", "bmm"):
            ops = node.args[:2]
        else:
            ops = node.args[:1]
        if not ops:
            return None
        return _widest([env.classify(a) for a in ops]), f"{leaf}()"
    if not isinstance(f, ast.Attribute):
        return None
    recv = env.classify(f.value)
    if leaf in ("index_add_", "scatter_add_", "index_add", "scatter_add"):
        src = node.args[-1] if node.args else None
        return _widest([recv, env.classify(src)]), f".{leaf}()"
    if leaf in ("matmul", "mm", "bmm") and node.args:
        return _widest([recv, env.classify(node.args[0])]), f".{leaf}()"
    if leaf in ("sum", "cumsum", "nansum"):
        return recv, f".{leaf}()"
    return None


def _order_sites(df: dfmod.DeviceDataflow
                 ) -> Dict[str, List[dfmod.CollectiveSite]]:
    """The order-dependent collective sites per function: float psum
    folds and reducing collectives, a wrapper's own primitive left to
    its call sites when it forwards its op."""
    out: Dict[str, List[dfmod.CollectiveSite]] = {}
    forwarding = {s.key for s in df.collective_sites
                  if s.kind == "process" and df.forwards_op(s)}
    for s in df.collective_sites:
        if s.kind == "fold" and s.name not in ("psum", "pmean"):
            continue
        if s.kind == "process":
            # a wrapper's own primitive is read at the wrapper's call
            # sites when it forwards its op, and only then
            if not s.reduces or s.key in forwarding \
                    or (s.via is not None and s.via not in forwarding):
                continue
            if s.op is not None and dfmod._leaf(s.op) in (
                    "MIN", "MAX", "BAND", "BOR", "BXOR"):
                continue
        out.setdefault(s.key, []).append(s)
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
    ann = _Annotations(cg)
    bymod = {m.relpath: m for m in mods}
    out: List[Tuple[Optional[str], Finding]] = []

    plain = _plain_versions(df)
    annotated: Set[str] = set(ann.precision) | ann.order
    for k in list(annotated):
        annotated |= _lexical_closure(df, k)
    order_sites = _order_sites(df)
    scope = df.device_fns | df.traced | annotated | plain \
        | df.spmd_reachable
    counts = {"numerics_functions": 0, "numerics_precision_sites":
              len(ann.precision), "numerics_order_sites": len(ann.order),
              "numerics_casts": 0, "numerics_accumulations": 0,
              "numerics_order_reductions": 0,
              "numerics_plain_versions": 0,
              "numerics_plain_comparisons": 0}
    counts["numerics_plain_versions"] = len(
        [k for k in plain if ".<locals>." not in cg.funcs[k].qualname])
    aliases_by_mod: Dict[str, Dict[str, str]] = {}

    for key in sorted(scope):
        fi = cg.funcs.get(key)
        if fi is None:
            continue
        mod = bymod.get(fi.relpath)
        if mod is None:
            continue
        counts["numerics_functions"] += 1
        if fi.relpath not in aliases_by_mod:
            aliases_by_mod[fi.relpath] = _module_aliases(mod)
        env = _DtypeEnv(fi.node, aliases_by_mod[fi.relpath])
        p_ann = ann.precision_for(cg, key)
        o_ann = ann.order_for(cg, key)

        def emit(rule, node, msg, ctx) -> None:
            out.append((fi.relpath, Finding(
                rule=rule, path=fi.relpath, line=node.lineno,
                message=f"{fi.qualname}: {msg}",
                context=f"{fi.qualname}:{ctx}")))

        for node in dfmod.own_nodes(fi.node):
            if not isinstance(node, (ast.Call, ast.BinOp, ast.Compare)):
                continue
            # (1) precision-narrowing
            if isinstance(node, ast.Call):
                cast = env.cast_site(node)
                if cast is not None:
                    tgt, src, _operand = cast
                    if tgt in (F32, F16, I32) and src in _WIDE:
                        counts["numerics_casts"] += 1
                        if p_ann is None:
                            emit("precision-narrowing", node,
                                 f"a {src} value is cast to {tgt} with no "
                                 f"@precision(bits=..., reason=...) budget "
                                 f"— if a guard makes this safe (span "
                                 f"guard, exact split), annotate the site "
                                 f"with it", f"narrow:{src}->{tgt}")
            # (2) accumulation-bound
            acc = _accum_site(node, env)
            if acc is not None:
                acc_cls, label = acc
                if acc_cls in _NARROW_FLOAT:
                    counts["numerics_accumulations"] += 1
                    terms = (p_ann or {}).get("accum_terms")
                    comp = bool((p_ann or {}).get("compensated"))
                    limit = 2 ** _MANTISSA[acc_cls]
                    if p_ann is None or (terms is None and not comp):
                        emit("accumulation-bound", node,
                             f"{label} accumulates in {acc_cls} with no "
                             f"static term bound — declare @precision("
                             f"accum_terms=N) (N <= 2**"
                             f"{_MANTISSA[acc_cls]}) or compensated=True, "
                             f"or accumulate in f64 via dtype=",
                             f"accum:{label}")
                    elif terms is not None and terms > limit:
                        emit("accumulation-bound", node,
                             f"declared accum_terms={terms} exceeds the "
                             f"{acc_cls} mantissa bound 2**"
                             f"{_MANTISSA[acc_cls]} — the sum loses "
                             f"integer exactness before the bound is "
                             f"reached", f"accum-over:{label}")
            # (4) mixed-dtype-comparison (the kernels' plain versions)
            if isinstance(node, ast.Compare) and key in plain:
                counts["numerics_plain_comparisons"] += 1
                sides = [node.left] + list(node.comparators)
                classes = [env.classify(s) for s in sides]
                if F32 in classes and F64 in classes:
                    emit("mixed-dtype-comparison", node,
                         "comparison mixes f32 and f64 operands in a CUDA "
                         "kernel's plain version — the implicit promotion "
                         "differs from the kernel's", "cmp:f32f64")
                elif any(env.is_int_float_cast(s) for s in sides):
                    emit("mixed-dtype-comparison", node,
                         "an integer value is cast to float to feed a "
                         "comparison in a CUDA kernel's plain version — "
                         "past 2**24 the rounding flips the branch "
                         "between the kernel and the plain version; "
                         "compare in integer space", "cmp:intcast")
        # (3) reduction-order-determinism
        for s in order_sites.get(key, ()):
            opnd = env.classify(s.operand) if s.operand is not None \
                else None
            if opnd in _INTS | {BOOL, NEUTRAL}:
                continue
            counts["numerics_order_reductions"] += 1
            if o_ann:
                continue
            what = (f"{s.name}() partition fold" if s.kind == "fold" else
                    f"{s.name}() SUM reduction across ranks")
            emit("reduction-order-determinism", s.call,
                 f"{what} over a {opnd or 'non-provable'} dtype — its "
                 f"grouping follows the partition or rank count; declare "
                 f"@order_insensitive(tolerance=...) (certified across "
                 f"partition counts) or make the operand integer/exact",
                 f"order:{s.name}")
    seen.update(counts)
    return out
