"""SPMD and in-place-write rules of the port (counterpart of the
reference's ``rules_spmd``).

Built on :mod:`filodb_tpu_torch.lint.dataflow` (collective sites,
rank-invariance, in-place writers). A collective that one rank of a
``torch.distributed`` group skips hangs every rank with no stack trace,
and a view read after its storage was overwritten in place computes on
the wrong data silently; no single-process CPU test catches either. Two
families:

  * ``spmd-collective-balance`` — a cross-process collective (a
    ``torch.distributed`` primitive, or a call of a project function that
    reaches one, such as ``parallel/distributed._all_reduce``) under
    Python control flow whose test the rank-invariance analysis cannot
    prove takes the same branch on every rank: a read of the rank, the
    clock, the environment or RNG, a rank's own data before agreement,
    or a parameter no declaration or caller makes rank-invariant
    (:func:`~filodb_tpu_torch.lint.ranks.rank_invariant`). The axis half:
    every string axis the code looks up on a mesh (``mesh.shape["shard"]``)
    must be one the project's meshes declare (``axis_names``).
  * ``donation-safety`` — the port's counterpart of donation is the
    in-place writer: a function that ``.copy_``s, ``index_copy_``s or
    slice-assigns into a parameter's storage (``parallel/shardstore.
    _append_step`` writes a flush's columns into the resident channels).
    At each call site: an argument written into and passed again in the
    same call; a view of a written argument taken before the call and
    read after it; and, when the written storage is the object's own
    (``self.<attr>``), any other device store of the same object (a cache
    of values derived from the old contents) that the calling method
    does not invalidate after the write (``self._aligned.clear()``,
    a rebind, ``del`` or ``pop``). The AST cannot tell which cached
    entries derive from the written storage, so every device store of
    the object counts: the reference's ``self.buf = step(self.buf)``
    exemption becomes the invalidation.

Not ported (``NOT_PORTED``): ``partition-spec-consistency`` and the
advisory ``donation-missing`` — eager PyTorch has neither PartitionSpecs
nor a donation API.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Sequence, Set, Tuple

from filodb_tpu_torch.lint import Finding, ModuleSource, register_rule
from filodb_tpu_torch.lint import callgraph as cgmod
from filodb_tpu_torch.lint import dataflow as dfmod
from filodb_tpu_torch.lint.astwalk import walk_nodes

register_rule("spmd-collective-balance", "spmd",
              "cross-process collective under rank-divergent control "
              "flow, or a mesh axis name the project's meshes do not "
              "declare")
register_rule("donation-safety", "spmd",
              "storage written in place while a view of it is read "
              "after the write, passed twice, or cached in live state "
              "that the write does not invalidate")


# -- collective balance -------------------------------------------------------

class _BalanceWalker:
    """The collective sites of one function body and the rank-divergent
    control context each sits under."""

    def __init__(self, env: dfmod.RankEnv, calls: Set[int]):
        self.env = env
        self.calls = calls
        self.hits: List[Tuple[ast.Call, str]] = []

    def walk(self, fn_node) -> None:
        body = [ast.Expr(fn_node.body)] if isinstance(fn_node, ast.Lambda) \
            else fn_node.body
        for stmt in body:
            self._walk(stmt, None)

    def _why(self, test, loop: bool) -> Optional[str]:
        ok = self.env.expr_inv(test) if loop else self.env.test_inv(test)
        if ok:
            return None
        text = ast.unparse(test)
        if len(text) > 60:
            text = text[:57] + "..."
        return (f"under a loop over {text!r}, whose length may differ by "
                f"rank" if loop else
                f"under a test ({text!r}) not proven rank-invariant")

    def _walk(self, node, why: Optional[str]) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda, ast.ClassDef)):
            return
        here = why
        if isinstance(node, (ast.If, ast.While, ast.IfExp)):
            here = here or self._why(node.test, False)
            # the test itself runs unconditionally
            self._walk(node.test, why)
            for child in ast.iter_child_nodes(node):
                if child is not node.test:
                    self._walk(child, here)
            return
        if isinstance(node, (ast.For, ast.AsyncFor)):
            here = here or self._why(node.iter, True)
            self._walk(node.iter, why)
            for child in node.body + node.orelse:
                self._walk(child, here)
            return
        if isinstance(node, ast.Call) and id(node) in self.calls \
                and here is not None:
            self.hits.append((node, here))
        for child in ast.iter_child_nodes(node):
            self._walk(child, here)


def _check_collectives(df: dfmod.DeviceDataflow, seen: Dict[str, int]
                       ) -> List[Tuple[str, Finding]]:
    out: List[Tuple[str, Finding]] = []
    by_fn: Dict[str, Set[int]] = {}
    for s in df.collective_sites:
        if s.kind == "process":
            by_fn.setdefault(s.key, set()).add(id(s.call))
    seen["spmd_process_collectives"] = sum(
        1 for s in df.collective_sites if s.kind == "process")
    seen["spmd_wrapper_calls"] = sum(
        1 for s in df.collective_sites if s.kind == "process" and s.via)
    seen["spmd_partition_folds"] = sum(
        1 for s in df.collective_sites if s.kind == "fold")
    for key in sorted(by_fn):
        fi = df.cg.funcs[key]
        w = _BalanceWalker(df.rank_env(key), by_fn[key])
        w.walk(fi.node)
        for call, why in w.hits:
            name = dfmod._leaf(call.func) or "collective"
            out.append((fi.relpath, Finding(
                rule="spmd-collective-balance", path=fi.relpath,
                line=call.lineno,
                message=(f"{fi.qualname}: cross-process collective "
                         f"{name}() {why} — a rank that skips it hangs "
                         f"the group"),
                context=f"{fi.qualname}:divergent:{name}")))
    return out


def _declared_axes(mods: Sequence[ModuleSource]) -> Set[str]:
    """Axis names the project's meshes declare: ``axis_names = (...)``
    (the port's ``Mesh``) and the reference-style ``Mesh(devs, names)``."""
    out: Set[str] = set()

    def strings(e) -> List[str]:
        if isinstance(e, ast.Constant) and isinstance(e.value, str):
            return [e.value]
        if isinstance(e, (ast.Tuple, ast.List)):
            return [x.value for x in e.elts if isinstance(x, ast.Constant)
                    and isinstance(x.value, str)]
        return []

    for mod in mods:
        for node in walk_nodes(mod.tree):
            if isinstance(node, (ast.Assign, ast.AnnAssign)) \
                    and node.value is not None:
                targets = node.targets if isinstance(node, ast.Assign) \
                    else [node.target]
                if any(dfmod._leaf(t) == "axis_names" for t in targets):
                    out.update(strings(node.value))
            elif isinstance(node, ast.Call) \
                    and dfmod._leaf(node.func) == "Mesh":
                cand = node.args[1] if len(node.args) >= 2 else None
                for kw in node.keywords:
                    if kw.arg == "axis_names":
                        cand = kw.value
                out.update(strings(cand))
    return out


def _check_axes(mods: Sequence[ModuleSource], seen: Dict[str, int]
                ) -> List[Tuple[str, Finding]]:
    out: List[Tuple[str, Finding]] = []
    axes = _declared_axes(mods)
    reads = 0
    for mod in mods:
        for node in walk_nodes(mod.tree):
            if not (isinstance(node, ast.Subscript)
                    and isinstance(node.value, ast.Attribute)
                    and node.value.attr == "shape"
                    and isinstance(node.slice, ast.Constant)
                    and isinstance(node.slice.value, str)):
                continue
            owner = dfmod._dotted(node.value.value) or ""
            if "mesh" not in owner.rsplit(".", 1)[-1].lower():
                continue
            reads += 1
            name = node.slice.value
            if axes and name not in axes:
                out.append((mod.relpath, Finding(
                    rule="spmd-collective-balance", path=mod.relpath,
                    line=node.lineno,
                    message=(f"{owner}.shape[{name!r}] names an axis no "
                             f"mesh of the project declares (axes: "
                             f"{', '.join(sorted(axes))})"),
                    context=f"axis:{owner}:{name}")))
    seen["spmd_mesh_axis_reads"] = reads
    return out


# -- in-place writes ----------------------------------------------------------

def _self_root(e) -> Optional[str]:
    """``attr`` when ``e`` is an attribute/subscript chain off
    ``self.attr``."""
    while isinstance(e, ast.Subscript) or (
            isinstance(e, ast.Attribute) and not (
                isinstance(e.value, ast.Name) and e.value.id == "self")):
        e = e.value
    if isinstance(e, ast.Attribute) and isinstance(e.value, ast.Name) \
            and e.value.id == "self":
        return e.attr
    return None


def _is_view_of(e, name: str) -> bool:
    """``e`` may share ``name``'s storage: the name itself, a slice, a
    view attribute or a view method of it."""
    while True:
        if isinstance(e, ast.Name):
            return e.id == name
        if isinstance(e, ast.Subscript):
            e = e.value
        elif isinstance(e, ast.Attribute) and e.attr in dfmod.VIEW_ATTRS:
            e = e.value
        elif isinstance(e, ast.Call) and isinstance(e.func, ast.Attribute) \
                and e.func.attr in dfmod.VIEW_METHODS:
            e = e.func.value
        else:
            return False


def _local_aliases(fn_node) -> Dict[str, ast.AST]:
    """local name -> the value it is bound to, for names bound once."""
    vals: Dict[str, List[ast.AST]] = {}
    for n in dfmod.own_nodes(fn_node):
        if isinstance(n, ast.Assign):
            for t in n.targets:
                if isinstance(t, ast.Name):
                    vals.setdefault(t.id, []).append(n.value)
    return {k: v[0] for k, v in vals.items() if len(v) == 1}


def _written_state(e, aliases: Dict[str, ast.AST]) -> Optional[str]:
    attr = _self_root(e)
    if attr is None and isinstance(e, ast.Name) and e.id in aliases:
        attr = _self_root(aliases[e.id])
    return attr


def _class_stores(df: dfmod.DeviceDataflow, fi: cgmod.FuncInfo
                  ) -> Dict[str, List[dfmod.Store]]:
    """The device stores of ``fi``'s class: attr -> its stores."""
    out: Dict[str, List[dfmod.Store]] = {}
    for k, t in df.escapes.items():
        ofi = df.cg.funcs.get(k)
        if ofi is None or ofi.cls != fi.cls or ofi.module != fi.module:
            continue
        for s in t.stores:
            out.setdefault(s.label[len("self."):].rstrip("[]"),
                           []).append(s)
    return out


def _assigned_from(df: dfmod.DeviceDataflow, fi: cgmod.FuncInfo,
                   written: Set[str]) -> Set[str]:
    """The attributes some method of ``fi``'s class binds to a value read
    from one of the ``written`` attributes (a view, an alias, or a value
    computed from the old contents)."""
    out: Set[str] = set()
    for ofi in df.cg.funcs.values():
        if ofi.cls != fi.cls or ofi.module != fi.module:
            continue
        for n in dfmod.own_nodes(ofi.node):
            if isinstance(n, ast.Assign) and any(
                    _self_root(m) in written for m in ast.walk(n.value)):
                out |= {a for a in (dfmod._self_attr(t) for t in n.targets)
                        if a}
    return out


def _invalidates(fn_node, attr: str, after: int) -> bool:
    """``self.<attr>`` is cleared, rebound, deleted or popped after line
    ``after`` in the function body."""
    for n in dfmod.own_nodes(fn_node):
        if getattr(n, "lineno", 0) <= after:
            continue
        if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute) \
                and n.func.attr in ("clear", "pop", "popitem") \
                and dfmod._self_attr(n.func.value) == attr:
            return True
        if isinstance(n, ast.Assign) and any(
                dfmod._self_attr(t) == attr for t in n.targets):
            return True
        if isinstance(n, ast.Delete) and any(
                _self_root(t) == attr for t in n.targets):
            return True
    return False


def _check_inplace(df: dfmod.DeviceDataflow, seen: Dict[str, int]
                   ) -> List[Tuple[str, Finding]]:
    out: List[Tuple[str, Finding]] = []
    seen["inplace_writers"] = len(df.inplace_writers)
    seen["inplace_write_sites"] = len(df.inplace_calls)
    for ic in df.inplace_calls:
        fi = df.cg.funcs[ic.key]
        wname = df.cg.funcs[ic.writer].qualname
        call = ic.call

        def emit(msg: str, ctx: str) -> None:
            out.append((fi.relpath, Finding(
                rule="donation-safety", path=fi.relpath, line=call.lineno,
                message=f"{fi.qualname}: {msg}",
                context=f"{fi.qualname}:{ctx}")))

        args = list(call.args) + [kw.value for kw in call.keywords]
        texts = [ast.unparse(a) for a in args]
        for w in ic.written:
            wt = ast.unparse(w)
            if texts.count(wt) > 1:
                emit(f"{wt!r} is written in place by {wname}() and passed "
                     f"to it again in the same call: the second read sees "
                     f"the write", f"double:{wt}")
        aliases = _local_aliases(fi.node)
        # views taken before the call and read after it
        for w in ic.written:
            r = dfmod.root_name(w)
            if r is None:
                continue
            for n in dfmod.own_nodes(fi.node):
                if not (isinstance(n, ast.Assign)
                        and n.lineno < call.lineno
                        and len(n.targets) == 1
                        and isinstance(n.targets[0], ast.Name)
                        and n.targets[0].id != r
                        and _is_view_of(n.value, r)):
                    continue
                v = n.targets[0].id
                rebinds = [m.lineno for m in dfmod.own_nodes(fi.node)
                           if isinstance(m, ast.Assign)
                           and m.lineno > call.lineno
                           and any(isinstance(t, ast.Name) and t.id == v
                                   for t in m.targets)]
                reads = [m.lineno for m in dfmod.own_nodes(fi.node)
                         if isinstance(m, ast.Name) and m.id == v
                         and isinstance(m.ctx, ast.Load)
                         and m.lineno > call.lineno
                         and not any(call.lineno < b <= m.lineno
                                     for b in rebinds)]
                if reads:
                    emit(f"{v!r} views the storage of {r!r}, which "
                         f"{wname}() overwrites in place here, and is read "
                         f"at line {min(reads)} after the write (copy it "
                         f"with .clone() before the call, or take it after)",
                         f"use-after:{v}")
        # the object's other device stores, derived from the old contents
        written = {a for a in (_written_state(w, aliases)
                               for w in ic.written) if a}
        if not written or fi.cls is None:
            continue
        caches = {a for a, stores in _class_stores(df, fi).items()
                  if any(s.label.endswith("[]") for s in stores)}
        for attr in sorted((caches | _assigned_from(df, fi, written))
                           - written):
            if not _invalidates(fi.node, attr, call.lineno):
                emit(f"{wname}() overwrites self.{sorted(written)[0]} in "
                     f"place, but self.{attr} (device values cached from "
                     f"this object's state) is not invalidated after the "
                     f"write — clear or rebind it in this method",
                     f"aliased:{attr}")
    return out


# -- entry point --------------------------------------------------------------

def check_project(mods: Sequence[ModuleSource],
                  cg: Optional[cgmod.CallGraph] = None,
                  df: Optional[dfmod.DeviceDataflow] = None,
                  seen: Optional[Dict[str, int]] = None
                  ) -> List[Tuple[Optional[str], Finding]]:
    if df is None:
        df = dfmod.build(mods, cg)
    if seen is None:
        seen = {}
    out: List[Tuple[Optional[str], Finding]] = []
    out.extend(_check_collectives(df, seen))
    out.extend(_check_axes(mods, seen))
    out.extend(_check_inplace(df, seen))
    return out
