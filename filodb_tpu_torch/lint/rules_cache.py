"""Cache-invalidation completeness (graftlint v3).

Every cache-soundness bug of the system this package ports (a
dispatch-scope key component, a watermark-coverage hole) was a
world-mutation event some cache failed to account for — found by a
human, after the fact. This family mechanizes the review using the declarations in
:mod:`filodb_tpu_torch.lint.caches` and the call-graph/bridge machinery in
:mod:`filodb_tpu_torch.lint.dataflow`:

  * ``cache-invalidation-completeness`` —
      - a **push** event (``invalidated_by``): every ``@publishes(ev)``
        function in the project must REACH the cache's hook method
        through the call graph, where listener/subscriber indirection
        (``mapper.subscribe(cb)`` ... ``for cb in self._subscribers:
        cb(ev)``) is crossed via inferred registration bridges. Delete
        the line that wires the results cache to topology events and
        this rule fires at the topology publisher.
      - a **pull** event (``validated_by``): each named lookup hook
        must reach an ``@event_source(ev)`` function — the check that
        compares the cached extent against the live epoch/watermark
        cannot silently rot out of the lookup path.
      - inventory hygiene: a declared event with neither a publisher
        nor a source, a hook name that resolves to no method, and a
        ``@publishes``/``@event_source`` marker naming an event no
        registry declares are each findings.
  * ``cache-unregistered`` — a class that is visibly a cache (name
    ends in ``Cache``, or ``__init__`` creates a dict attribute whose
    name says cache) with no ``@cache_registry`` declaration: an
    unregistered cache is one nobody has answered "what invalidates
    this?" for.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

from filodb_tpu_torch.lint import Finding, ModuleSource, register_rule
from filodb_tpu_torch.lint import callgraph as cgmod
from filodb_tpu_torch.lint import dataflow as dfmod

register_rule("cache-invalidation-completeness", "cache",
              "a key-affecting event's publisher does not reach a "
              "registered cache's invalidation hook (or a lookup hook "
              "lost its event source)")
from filodb_tpu_torch.lint.astwalk import walk_nodes
register_rule("cache-unregistered", "cache",
              "a cache class carries no @cache_registry declaration "
              "(nobody has declared what invalidates it)")


@dataclass
class _Registry:
    name: str
    owner_cls: Optional[str]        # class name (None: module-level)
    module: str
    relpath: str
    line: int
    invalidated_by: Dict[str, str] = field(default_factory=dict)
    validated_by: Dict[str, Tuple[str, ...]] = field(
        default_factory=dict)
    keyed: Tuple[str, ...] = ()


def _const(expr):
    """Python value of a constant-literal expression (str/tuple/dict),
    or None when it is not one."""
    if isinstance(expr, ast.Constant):
        return expr.value
    if isinstance(expr, (ast.Tuple, ast.List)):
        out = []
        for e in expr.elts:
            v = _const(e)
            if v is None:
                return None
            out.append(v)
        return tuple(out)
    if isinstance(expr, ast.Dict):
        out = {}
        for k, v in zip(expr.keys, expr.values):
            kk, vv = _const(k), _const(v)
            if kk is None or vv is None:
                return None
            out[kk] = vv
        return out
    return None


def _norm_hooks(v) -> Tuple[str, ...]:
    if isinstance(v, str):
        return (v,)
    if isinstance(v, (list, tuple)):
        return tuple(x for x in v if isinstance(x, str))
    return ()


def _collect_registries(cg: cgmod.CallGraph,
                        mods: Sequence[ModuleSource]
                        ) -> Tuple[List[_Registry], Set[str]]:
    """All @cache_registry / __cache_registry__ declarations, plus the
    set of class names that carry at least one."""
    regs: List[_Registry] = []
    registered_classes: Set[str] = set()
    for ci in cg._classes_by_mod.values():
        for d in ci.node.decorator_list:
            if not isinstance(d, ast.Call):
                continue
            if dfmod._leaf(d.func) != "cache_registry":
                continue
            registered_classes.add(ci.name)
            name = _const(d.args[0]) if d.args else None
            reg = _Registry(name=str(name or ci.name),
                            owner_cls=ci.name, module=ci.module,
                            relpath=ci.relpath, line=d.lineno)
            for kw in d.keywords:
                v = _const(kw.value)
                if kw.arg == "invalidated_by" and isinstance(v, dict):
                    reg.invalidated_by = {str(k): str(h)
                                          for k, h in v.items()}
                elif kw.arg == "validated_by" and isinstance(v, dict):
                    reg.validated_by = {str(k): _norm_hooks(h)
                                        for k, h in v.items()}
                elif kw.arg == "keyed" and isinstance(v, tuple):
                    reg.keyed = v
            regs.append(reg)
    for mod in mods:
        dotted = cgmod.module_dotted(mod.relpath)
        for node in mod.tree.body:
            if not isinstance(node, ast.Assign):
                continue
            for t in node.targets:
                if isinstance(t, ast.Name) \
                        and t.id == "__cache_registry__":
                    table = _const(node.value)
                    if not isinstance(table, dict):
                        continue
                    for name, entry in table.items():
                        if not isinstance(entry, dict):
                            continue
                        reg = _Registry(
                            name=str(name), owner_cls=None,
                            module=dotted, relpath=mod.relpath,
                            line=node.lineno,
                            invalidated_by={
                                str(k): str(v) for k, v in
                                (entry.get("invalidated_by")
                                 or {}).items()},
                            validated_by={
                                str(k): _norm_hooks(v) for k, v in
                                (entry.get("validated_by")
                                 or {}).items()},
                            keyed=tuple(entry.get("keyed") or ()))
                        regs.append(reg)
    return regs, registered_classes


def _collect_marked(cg: cgmod.CallGraph, marker: str
                    ) -> Dict[str, List[str]]:
    """event -> [func keys] for @publishes / @event_source markers."""
    out: Dict[str, List[str]] = {}
    for key, fi in cg.funcs.items():
        for d in getattr(fi.node, "decorator_list", ()):
            if not isinstance(d, ast.Call):
                continue
            if dfmod._leaf(d.func) != marker:
                continue
            for a in d.args:
                if isinstance(a, ast.Constant) \
                        and isinstance(a.value, str):
                    out.setdefault(a.value, []).append(key)
    return out


def _resolve_hook(cg: cgmod.CallGraph, reg: _Registry,
                  hook: str) -> Optional[str]:
    if reg.owner_cls is not None:
        return cg.resolve_method(reg.owner_cls, hook)
    k = f"{reg.module}:{hook}"
    return k if k in cg.funcs else None


def _fmt_path(cg: cgmod.CallGraph, path: Sequence[str]) -> str:
    names = [cg.funcs[k].qualname for k in path if k in cg.funcs]
    return " -> ".join(names[:6]) + (" ..." if len(names) > 6 else "")


def check_project(mods: Sequence[ModuleSource],
                  cg: Optional[cgmod.CallGraph] = None,
                  df: Optional[dfmod.DeviceDataflow] = None
                  ) -> List[Tuple[Optional[str], Finding]]:
    if df is None:
        df = dfmod.build(mods, cg)
    cg = df.cg
    out: List[Tuple[Optional[str], Finding]] = []
    regs, registered = _collect_registries(cg, mods)
    publishers = _collect_marked(cg, "publishes")
    sources = _collect_marked(cg, "event_source")
    declared_events: Set[str] = set()
    for reg in regs:
        declared_events |= set(reg.invalidated_by)
        declared_events |= set(reg.validated_by)

    def emit(relpath, line, msg, ctx) -> None:
        out.append((relpath, Finding(
            rule="cache-invalidation-completeness", path=relpath,
            line=line, message=msg, context=ctx)))

    for reg in regs:
        # push events: every publisher must reach the hook
        for ev, hook in sorted(reg.invalidated_by.items()):
            hk = _resolve_hook(cg, reg, hook)
            if hk is None:
                emit(reg.relpath, reg.line,
                     f"cache {reg.name!r}: invalidation hook {hook!r} "
                     f"for event {ev!r} resolves to no method",
                     f"registry:{reg.name}:{ev}:missing-hook")
                continue
            pubs = publishers.get(ev, [])
            if not pubs and ev not in sources:
                emit(reg.relpath, reg.line,
                     f"cache {reg.name!r}: event {ev!r} has no "
                     f"@publishes publisher anywhere in the project — "
                     f"either the event inventory or the publisher "
                     f"marker is missing",
                     f"registry:{reg.name}:{ev}:unpublished")
            for pk in pubs:
                if df.reaches(pk, hk) is None:
                    pfi = cg.funcs[pk]
                    emit(pfi.relpath, pfi.lineno,
                         f"{pfi.qualname} publishes {ev!r} but does "
                         f"not reach cache {reg.name!r}'s invalidation "
                         f"hook {reg.owner_cls or reg.module}.{hook} "
                         f"through any call/subscription path — the "
                         f"cache serves stale entries across this "
                         f"event",
                         f"publish:{ev}:{reg.name}:{pfi.qualname}")
        # pull events: each lookup hook must consult an event source
        for ev, hooks in sorted(reg.validated_by.items()):
            srcs = sources.get(ev, [])
            if not srcs:
                emit(reg.relpath, reg.line,
                     f"cache {reg.name!r}: pull event {ev!r} has no "
                     f"@event_source function in the project",
                     f"registry:{reg.name}:{ev}:no-source")
                continue
            for hook in hooks:
                hk = _resolve_hook(cg, reg, hook)
                if hk is None:
                    emit(reg.relpath, reg.line,
                         f"cache {reg.name!r}: lookup hook {hook!r} "
                         f"for pull event {ev!r} resolves to no "
                         f"method",
                         f"registry:{reg.name}:{ev}:missing-hook:"
                         f"{hook}")
                    continue
                if all(df.reaches(hk, sk) is None for sk in srcs):
                    hfi = cg.funcs[hk]
                    emit(hfi.relpath, hfi.lineno,
                         f"{hfi.qualname} is declared to validate "
                         f"cache {reg.name!r} against {ev!r} but never "
                         f"reads its @event_source — lookups no "
                         f"longer check this event",
                         f"pull:{ev}:{reg.name}:{hook}")
    # stale markers: events nothing declares
    for ev, keys in sorted(publishers.items()):
        if ev in declared_events:
            continue
        for pk in keys:
            pfi = cg.funcs[pk]
            emit(pfi.relpath, pfi.lineno,
                 f"{pfi.qualname} publishes {ev!r} but no "
                 f"@cache_registry declares that event — stale marker "
                 f"or missing registry entry",
                 f"orphan-publish:{ev}:{pfi.qualname}")
    for ev, keys in sorted(sources.items()):
        if ev in declared_events:
            continue
        for sk in keys:
            sfi = cg.funcs[sk]
            emit(sfi.relpath, sfi.lineno,
                 f"{sfi.qualname} is an @event_source for {ev!r} but "
                 f"no @cache_registry declares that event",
                 f"orphan-source:{ev}:{sfi.qualname}")
    # unregistered caches
    for ci in cg._classes_by_mod.values():
        if ci.name in registered:
            continue
        looks_like = ci.name.endswith("Cache")
        attr = None
        init = ci.methods.get("__init__")
        if init is not None and not looks_like:
            for node in walk_nodes(init.node):
                tgt = None
                if isinstance(node, ast.Assign) \
                        and len(node.targets) == 1:
                    tgt, val = node.targets[0], node.value
                elif isinstance(node, ast.AnnAssign) \
                        and node.value is not None:
                    tgt, val = node.target, node.value
                else:
                    continue
                if not (isinstance(tgt, ast.Attribute)
                        and isinstance(tgt.value, ast.Name)
                        and tgt.value.id == "self"):
                    continue
                name = tgt.attr
                if "cache" not in name.lower() \
                        or name.endswith("_lock"):
                    continue
                if isinstance(val, ast.Dict) or (
                        isinstance(val, ast.Call)
                        and dfmod._leaf(val.func) in ("dict",
                                                      "OrderedDict")):
                    attr = name
                    break
        if looks_like or attr is not None:
            why = f"dict attribute {attr!r}" if attr else "its name"
            out.append((ci.relpath, Finding(
                rule="cache-unregistered", path=ci.relpath,
                line=ci.node.lineno,
                message=(f"class {ci.name} looks like a cache "
                         f"({why}) but carries no @cache_registry "
                         f"declaration — declare its key-affecting "
                         f"events (filodb_tpu_torch/lint/caches.py)"),
                context=f"unregistered:{ci.name}")))
    return out
