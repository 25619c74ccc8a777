"""Device-memory residency & capacity rules of the port.

Built on the :mod:`filodb_tpu_torch.lint.callgraph` /
:mod:`filodb_tpu_torch.lint.dataflow` engine, whose device taint tracks
torch device allocations (``torch.zeros(..., device=dev)``,
``torch.as_tensor(x, device=dev)``, ``.to(dev)``, ``.cuda()``, ...)
through locals, returns, constructors and parameters into LONG-LIVED
stores — object attributes and ``@cache_registry`` inventory dicts — and
holds every escape to the ``@capacity`` bytes budgets of
:mod:`filodb_tpu_torch.lint.capacity` (certified dynamically by
:mod:`filodb_tpu_torch.lint.memcert`). Four error families:

  * ``hbm-residency-budget`` — a device tensor escapes into a long-lived
    store from a host-side function that carries no
    ``@capacity(bytes_per_sample=..., reason=...)`` claim on itself, a
    lexical ancestor, or its class; or a module-level device tensor.
    Unaccounted residency is how a card's memory fills with buffers
    nobody priced.
  * ``device-buffer-leak`` — lifetime analysis over the registered cache
    inventory: a ``@cache_registry`` store that accumulates device
    tensors by subscript must have an eviction operation
    (``pop``/``del``/``clear``/FIFO cap/weakref finalizer) on that
    attribute, and when the registry declares ``invalidated_by`` hooks,
    an eviction site reachable from a hook through the call graph. Also:
    one device buffer stored into two different stores in one function
    (double retention — the ledger double-counts and neither store owns
    eviction).
  * ``oversized-transfer`` — inside ``@hot_path`` functions: a
    device->host pull of a whole resident channel (``self.x.cpu()``,
    ``.numpy()``, ``.tolist()``, ``.to("cpu")`` or ``np.asarray`` of a
    bare store attribute — slice on the device first), or a host->device
    transfer (``torch.as_tensor(x, device=)``, ``x.to(dev)``,
    ``x.cuda()``) of a buffer whose allocation is pow2-capacity-padded
    (``_next_pow2``/``_pad_pow2`` in the shape) when the unpadded slice
    would do; ``@capacity`` on the site declares the padding priced and
    exempts it.
  * ``smem-frontier-budget`` — the counterpart of the reference's VMEM
    frontier family, for the group-sum's launch planner: an
    ``smem_budget`` parameter must stay under a block's opt-in shared
    memory (:data:`filodb_tpu_torch.lint.contracts.SMEM_OPTIN_BYTES`),
    a planner (a function that loops) must TEST against its budget, and
    — when ``query/kernels.py`` is in the lint set — a sweep of
    ``groupsum_launch_plan`` over shapes, groups, boundary modes and SM
    counts: every plan's dynamic shared memory (``groupsum_smem``, the
    Python side of ``csrc/counter_groupsum.cu``'s ``layout()``) plus the
    partial kernel's static shared bytes must fit the
    ``counter_groupsum`` contract's budget, and the planner must not
    raise for a workload whose minimal configuration (one stage) fits.
    That the CUDA layout agrees with ``groupsum_smem`` is read on the
    card, from the library's ``counter_groupsum_geometry``.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Sequence, Set, Tuple

from filodb_tpu_torch.lint import Finding, ModuleSource, register_rule
from filodb_tpu_torch.lint import callgraph as cgmod
from filodb_tpu_torch.lint import contracts as contracts_mod
from filodb_tpu_torch.lint import dataflow as dfmod
from filodb_tpu_torch.lint.astwalk import walk_nodes
from filodb_tpu_torch.lint.rules_cache import _collect_registries, _const

register_rule("hbm-residency-budget", "capacity",
              "a device allocation escapes into a long-lived store "
              "(object attr / module global / registry dict) without a "
              "@capacity(bytes_per_sample=..., reason=...) claim")
register_rule("device-buffer-leak", "capacity",
              "device tensors retained in a registered store with no "
              "eviction path reachable from its invalidation events, "
              "or one buffer double-retained by two stores")
register_rule("oversized-transfer", "capacity",
              "hot-path host<->device transfer of a whole resident "
              "channel or of a capacity-padded buffer where a slice "
              "suffices")
register_rule("smem-frontier-budget", "capacity",
              "launch-planner arithmetic disagrees with the declared "
              "shared-memory budget: budget above a block's opt-in "
              "limit, a planner that never tests its budget, or a plan "
              "that does not fit (or a refusal where one stage fits)")

# device->host pulls of a store attribute (the whole-channel check)
_PULL_METHODS = {"cpu", "numpy", "tolist"}
_PULL_NP = {"asarray", "array"}


def _self_attr(e) -> Optional[str]:
    """'attr' when ``e`` is ``self.attr``, else None."""
    if isinstance(e, ast.Attribute) and isinstance(e.value, ast.Name) \
            and e.value.id == "self":
        return e.attr
    return None


# -- @capacity annotation discovery ------------------------------------------


class _CapacityAnnotations:
    """Function keys and class names carrying ``@capacity``."""

    def __init__(self, cg: cgmod.CallGraph):
        self.funcs: Set[str] = set()
        self.classes: Set[Tuple[str, str]] = set()   # (module, cls)
        for key, fi in cg.funcs.items():
            node = fi.node
            if isinstance(node, ast.Lambda):
                continue
            for d in node.decorator_list:
                target = d.func if isinstance(d, ast.Call) else d
                if dfmod._leaf(target) == "capacity":
                    self.funcs.add(key)
        for (module, cls), ci in cg._classes_by_mod.items():
            for d in ci.node.decorator_list:
                target = d.func if isinstance(d, ast.Call) else d
                if dfmod._leaf(target) == "capacity":
                    self.classes.add((module, cls))

    def covers(self, cg: cgmod.CallGraph, key: str) -> bool:
        fi = cg.funcs.get(key)
        if fi is None:
            return False
        qual = fi.qualname
        keys = [key]
        while ".<locals>." in qual:
            qual = qual.rsplit(".<locals>.", 1)[0]
            keys.append(f"{fi.module}:{qual}")
        if any(k in self.funcs for k in keys):
            return True
        return fi.cls is not None and (fi.module, fi.cls) in self.classes


# -- shared-memory frontier --------------------------------------------------


def sweep_groupsum_frontier(km, budget: int, static_smem: int = 0
                            ) -> List[Tuple[str, Tuple]]:
    """Sweep ``km.groupsum_launch_plan`` over its workloads; return the
    violations as (kind, point): 'overflow' when a plan's shared memory
    (its own figure or ``km.groupsum_smem`` of its stages, whichever is
    larger, plus ``static_smem``) exceeds ``budget``, 'bad-plan' when
    stages or chunk leave their range, 'premature-refusal' when the
    planner raises although one stage fits."""
    bad: List[Tuple[str, Tuple]] = []
    modes = (km.GS_BOTH, km.GS_CUR, km.GS_ALT)
    for n_s in (1, 8, 128, 65_535):
        for T in (1, 7, 8, 469, 2_880):
            for G in (1, 2, 5, 16, 17, 300):
                for hi in modes:
                    for lo in modes:
                        for n_sm in (1, 132):
                            pt = (n_s, T, G, hi, lo, n_sm)
                            fams = 2 + (hi != km.GS_CUR) \
                                + (lo != km.GS_CUR)
                            cw = 1
                            while 4 * cw < min(G, km.GS_GC):
                                cw *= 2
                            nbuf = 2 if G <= km.GS_GC else 1
                            try:
                                lp = km.groupsum_launch_plan(
                                    n_s, T, G, hi, lo, n_sm)
                            except (ValueError, AssertionError):
                                one = km.groupsum_smem(1, fams, cw, nbuf) \
                                    + static_smem
                                if one <= budget:
                                    bad.append(("premature-refusal",
                                                pt + (one,)))
                                continue
                            need = max(lp["smem"], km.groupsum_smem(
                                lp["stages"], fams, cw, nbuf)) + static_smem
                            if need > budget:
                                bad.append(("overflow",
                                            pt + (lp["stages"], need)))
                            elif not (1 <= lp["stages"]
                                      <= km.GS_STAGES_MAX
                                      and 1 <= lp["chunk"]
                                      and lp["n_chunks"] * lp["chunk"]
                                      >= T):
                                bad.append(("bad-plan",
                                            pt + (lp["stages"],
                                                  lp["chunk"])))
    return bad


def _module_int_consts(tree: ast.Module) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for node in tree.body:
        if isinstance(node, ast.Assign):
            v = _int_const(node.value)
            if v is not None:
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        out[t.id] = v
    return out


def _check_smem_frontier(mods: Sequence[ModuleSource],
                         cg: cgmod.CallGraph
                         ) -> List[Tuple[Optional[str], Finding]]:
    out: List[Tuple[Optional[str], Finding]] = []
    consts = {cgmod.module_dotted(m.relpath): _module_int_consts(m.tree)
              for m in mods}
    for key, fi in sorted(cg.funcs.items()):
        node = fi.node
        if isinstance(node, ast.Lambda):
            continue
        args = node.args
        names = [a.arg for a in args.args] \
            + [a.arg for a in args.kwonlyargs]
        if "smem_budget" not in names:
            continue
        # (1) the declared default must fit a block's shared memory
        declared: Optional[int] = None
        defaults = list(zip(reversed(args.args), reversed(args.defaults)))
        defaults += [(a, d) for a, d in zip(args.kwonlyargs,
                                            args.kw_defaults)
                     if d is not None]
        for a, d in defaults:
            if a.arg == "smem_budget":
                declared = _int_const(d)
                if declared is None and isinstance(d, ast.Name):
                    declared = consts.get(fi.module, {}).get(d.id)
        if declared is not None \
                and declared > contracts_mod.SMEM_OPTIN_BYTES:
            out.append((fi.relpath, Finding(
                rule="smem-frontier-budget", path=fi.relpath,
                line=fi.lineno,
                message=(f"{fi.qualname}: smem_budget default "
                         f"{declared} exceeds a block's opt-in shared "
                         f"memory ({contracts_mod.SMEM_OPTIN_BYTES}) — "
                         f"a planner can admit a plan no launch can "
                         f"take"),
                context=f"{fi.qualname}:budget-over-smem")))
        # (2) a planner (a function that WALKS a frontier — it loops)
        # must TEST against its budget somewhere
        is_planner = any(isinstance(n, (ast.For, ast.While))
                         for n in ast.walk(node))
        uses_budget = any(
            isinstance(n, ast.Compare) and any(
                isinstance(side, ast.Name) and side.id == "smem_budget"
                for side in [n.left] + list(n.comparators))
            for n in ast.walk(node))
        if is_planner and not uses_budget:
            out.append((fi.relpath, Finding(
                rule="smem-frontier-budget", path=fi.relpath,
                line=fi.lineno,
                message=(f"{fi.qualname}: takes an smem_budget but "
                         f"never compares a footprint against it — "
                         f"the frontier walk is unbudgeted"),
                context=f"{fi.qualname}:budget-unused")))
    # (3) sweep of the in-tree group-sum planner against its contract,
    # when the kernel module is being linted
    krel = "filodb_tpu_torch/query/kernels.py"
    if any(m.relpath == krel for m in mods):
        import importlib
        km = importlib.import_module("filodb_tpu_torch.query.kernels")
        contract = contracts_mod.CONTRACTS.get(
            ("filodb_tpu_torch.query.kernels", "counter_groupsum"))
        budget = (contract.smem_budget if contract and contract.smem_budget
                  else contracts_mod.SMEM_OPTIN_BYTES)
        part = contract.kernel("groupsum_partial_kernel") \
            if contract else None
        static = part.static_smem if part else 0
        line = 1
        for m in mods:
            if m.relpath == krel:
                for i, ln in enumerate(m.lines, start=1):
                    if "def groupsum_launch_plan" in ln:
                        line = i
                        break
        for kind, pt in sweep_groupsum_frontier(km, budget, static)[:8]:
            out.append((krel, Finding(
                rule="smem-frontier-budget", path=krel, line=line,
                message=(f"groupsum_launch_plan {kind} at (n_s, T, G, "
                         f"hi, lo, n_sm) = {pt[:6]}: {pt[6:]} against "
                         f"the contract budget {budget}"),
                context=f"gs-frontier:{kind}:{pt[:6]}")))
    return out


def _int_const(e) -> Optional[int]:
    """Tiny constant folder for annotation kwargs (232_448, 48 << 10)."""
    if isinstance(e, ast.Constant) and isinstance(e.value, int) \
            and not isinstance(e.value, bool):
        return e.value
    if isinstance(e, ast.BinOp):
        lft, rgt = _int_const(e.left), _int_const(e.right)
        if lft is None or rgt is None:
            return None
        try:
            if isinstance(e.op, ast.Pow):
                return lft ** rgt
            if isinstance(e.op, ast.LShift):
                return lft << rgt
            if isinstance(e.op, ast.Mult):
                return lft * rgt
            if isinstance(e.op, ast.Add):
                return lft + rgt
            if isinstance(e.op, ast.Sub):
                return lft - rgt
        except (OverflowError, ValueError):
            return None
    if isinstance(e, ast.UnaryOp) and isinstance(e.op, ast.USub):
        v = _int_const(e.operand)
        return -v if v is not None else None
    return None


# -- hot-path transfer scope -------------------------------------------------


def _hot_keys(cg: cgmod.CallGraph, mods: Sequence[ModuleSource]
              ) -> Set[str]:
    hot: Set[str] = set()
    for key, fi in cg.funcs.items():
        node = fi.node
        if isinstance(node, ast.Lambda):
            continue
        for d in node.decorator_list:
            target = d.func if isinstance(d, ast.Call) else d
            if dfmod._leaf(target) == "hot_path":
                hot.add(key)
    for mod in mods:
        dotted = cgmod.module_dotted(mod.relpath)
        for node in mod.tree.body:
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    if isinstance(t, ast.Name) and t.id == "__hot_path__":
                        v = _const(node.value)
                        if isinstance(v, tuple):
                            for name in v:
                                hot.add(f"{dotted}:{name}")
    return hot


def _pow2_padded_locals(fn_node) -> Set[str]:
    """Locals whose allocation shape runs through a pow2 capacity pad
    (``_next_pow2``/``_pad_pow2``), plus the pad-width names feeding
    them."""
    padded: Set[str] = set()
    pad_names: Set[str] = set()
    for _ in range(2):
        for node in dfmod.own_nodes(fn_node):
            if not isinstance(node, ast.Assign) or len(node.targets) != 1:
                continue
            t = node.targets[0]
            if not isinstance(t, ast.Name):
                continue
            uses_pad = False
            for n in ast.walk(node.value):
                if isinstance(n, ast.Call) and dfmod._leaf(n.func) in \
                        ("_next_pow2", "_pad_pow2", "next_pow2"):
                    uses_pad = True
                if isinstance(n, ast.Name) and n.id in pad_names:
                    uses_pad = True
            if uses_pad:
                pad_names.add(t.id)
                if isinstance(node.value, ast.Call) and \
                        dfmod._leaf(node.value.func) in (
                            "zeros", "full", "empty", "ones"):
                    padded.add(t.id)
    return padded


def _whole_channel_pull(call: ast.Call) -> Optional[str]:
    """The store attribute a call pulls whole to the host, or None."""
    f = call.func
    if isinstance(f, ast.Attribute) and (
            f.attr in _PULL_METHODS or dfmod.is_host_pull(call)):
        return _self_attr(f.value)
    if dfmod._leaf(f) in _PULL_NP and dfmod.call_base(call) in (
            "np", "numpy") and call.args:
        return _self_attr(call.args[0])
    return None


def _check_transfers(cg: cgmod.CallGraph, df: dfmod.DeviceDataflow,
                     mods: Sequence[ModuleSource],
                     ann: _CapacityAnnotations
                     ) -> List[Tuple[Optional[str], Finding]]:
    out: List[Tuple[Optional[str], Finding]] = []
    for key in sorted(_hot_keys(cg, mods)):
        fi = cg.funcs.get(key)
        if fi is None or ann.covers(cg, key):
            continue
        aliases = df.dtype_aliases.get(fi.module, set())
        padded = _pow2_padded_locals(fi.node)
        for call in dfmod.own_nodes(fi.node):
            if not isinstance(call, ast.Call):
                continue
            # (i) whole-resident-channel pull to host
            attr = _whole_channel_pull(call)
            if attr is not None:
                out.append((fi.relpath, Finding(
                    rule="oversized-transfer", path=fi.relpath,
                    line=call.lineno,
                    message=(f"{fi.qualname}: pulls the whole resident "
                             f"channel self.{attr} to the host on the "
                             f"hot path — slice on the device and "
                             f"transfer the window"),
                    context=f"{fi.qualname}:pull:{attr}")))
            # (ii) capacity-padded buffer shipped to the device
            if dfmod.is_h2d_transfer(call, aliases):
                src = dfmod.h2d_source(call)
                if isinstance(src, ast.Name) and src.id in padded:
                    out.append((fi.relpath, Finding(
                        rule="oversized-transfer", path=fi.relpath,
                        line=call.lineno,
                        message=(f"{fi.qualname}: transfers the "
                                 f"pow2-capacity-padded buffer "
                                 f"{src.id!r} to the device on the hot "
                                 f"path — pad on the device or ship the "
                                 f"exact slice (@capacity declares the "
                                 f"padding priced if deliberate)"),
                        context=f"{fi.qualname}:padded:{src.id}")))
    return out


# -- leak analysis -----------------------------------------------------------

_EVICT_CALL_LEAVES = {"pop", "popitem", "clear"}


def _evicts_attr(fn_node, attr: str) -> bool:
    """The function body evicts from ``self.<attr>`` (pop/del/clear/
    reassign-to-empty) or wires a weakref finalizer."""
    for node in walk_nodes(fn_node):
        if isinstance(node, ast.Call):
            f = node.func
            if isinstance(f, ast.Attribute) \
                    and f.attr in _EVICT_CALL_LEAVES:
                if _self_attr(f.value) == attr:
                    return True
            leaf = dfmod._leaf(f)
            if leaf in ("ref", "finalize") \
                    and (dfmod.call_base(node) or "").endswith("weakref"):
                return True
        if isinstance(node, ast.Delete):
            for t in node.targets:
                if isinstance(t, ast.Subscript) \
                        and _self_attr(t.value) == attr:
                    return True
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if _self_attr(t) == attr and isinstance(
                        node.value, (ast.Dict, ast.List)) \
                        and not getattr(node.value, "keys",
                                        getattr(node.value, "elts", ())):
                    return True
    return False


def _check_leaks(cg: cgmod.CallGraph, df: dfmod.DeviceDataflow,
                 mods: Sequence[ModuleSource]
                 ) -> List[Tuple[Optional[str], Finding]]:
    out: List[Tuple[Optional[str], Finding]] = []
    regs, _ = _collect_registries(cg, mods)
    regs_by_cls: Dict[str, list] = {}
    for reg in regs:
        if reg.owner_cls:
            regs_by_cls.setdefault(reg.owner_cls, []).append(reg)

    # (a) registered stores accumulating device tensors need eviction
    for (module, cls), ci in sorted(cg._classes_by_mod.items()):
        if cls not in regs_by_cls:
            continue
        grown: Dict[str, Tuple[str, int]] = {}   # attr -> (key, line)
        for mname, mfi in ci.methods.items():
            esc = df.escapes.get(mfi.key)
            if esc is None:
                continue
            for st in esc.stores:
                if st.label.endswith("[]"):
                    grown.setdefault(st.label[5:-2], (mfi.key, st.line))
        for attr, (store_key, line) in sorted(grown.items()):
            evictors = [m for m in ci.methods.values()
                        if m.name != "__init__"
                        and _evicts_attr(m.node, attr)]
            # a finalizer/FIFO-cap in the storing method itself counts
            store_fi = cg.funcs.get(store_key)
            if store_fi is not None \
                    and _evicts_attr(store_fi.node, attr):
                evictors.append(store_fi)
            if not evictors:
                out.append((ci.relpath, Finding(
                    rule="device-buffer-leak", path=ci.relpath,
                    line=line,
                    message=(
                        f"{cls}.{attr} accumulates device tensors with "
                        f"no eviction operation anywhere in the class "
                        f"(no pop/del/clear/weakref finalizer) — the "
                        f"store can only grow"),
                    context=f"{cls}.{attr}:no-eviction")))
                continue
            # invalidation-event reachability: when the registry
            # declares hooks, some eviction site must be reachable
            # from one of them
            hooks: List[str] = []
            for reg in regs_by_cls[cls]:
                for hook in reg.invalidated_by.values():
                    hk = cg.resolve_method(cls, hook)
                    if hk:
                        hooks.append(hk)
            if hooks:
                reachable = False
                for hk in hooks:
                    for ev in evictors:
                        if hk == ev.key \
                                or df.reaches(hk, ev.key) is not None:
                            reachable = True
                if not reachable:
                    out.append((ci.relpath, Finding(
                        rule="device-buffer-leak", path=ci.relpath,
                        line=line,
                        message=(
                            f"{cls}.{attr} holds device tensors but no "
                            f"eviction site is reachable from the "
                            f"registry's invalidation hooks — the "
                            f"declared events never free the bytes"),
                        context=f"{cls}.{attr}:unreachable-eviction")))

    # (b) double retention of one buffer by two stores
    for key, esc in sorted(df.escapes.items()):
        fi = cg.funcs.get(key)
        if fi is None:
            continue
        by_name: Dict[str, List[Tuple[str, int]]] = {}
        for st in esc.stores:
            if not st.taint.startswith("<"):
                by_name.setdefault(st.taint, []).append((st.label,
                                                         st.line))
        for name, sites in sorted(by_name.items()):
            stores = sorted({lab for lab, _ in sites})
            if len(stores) > 1:
                line = min(ln for _, ln in sites)
                out.append((fi.relpath, Finding(
                    rule="device-buffer-leak", path=fi.relpath,
                    line=line,
                    message=(
                        f"{fi.qualname}: buffer {name!r} is retained "
                        f"by {len(stores)} stores "
                        f"({', '.join(stores)}) — double-counted "
                        f"residency with no single eviction owner"),
                    context=f"{fi.qualname}:double:{name}")))
    return out


# -- entry -------------------------------------------------------------------


def _module_resident(mods: Sequence[ModuleSource],
                     df: dfmod.DeviceDataflow
                     ) -> List[Tuple[Optional[str], Finding]]:
    """Module-level device tensors: NAME = torch.zeros(..., device=...)
    at top level lives for the process."""
    out: List[Tuple[Optional[str], Finding]] = []
    for mod in mods:
        dotted = cgmod.module_dotted(mod.relpath)
        aliases = df.dtype_aliases.get(dotted, set())
        for node in mod.tree.body:
            if not isinstance(node, ast.Assign) or not any(
                    dfmod.is_device_alloc(n, aliases)
                    for n in ast.walk(node.value)):
                continue
            names = [t.id for t in node.targets if isinstance(t, ast.Name)]
            if not names:
                continue
            out.append((mod.relpath, Finding(
                rule="hbm-residency-budget", path=mod.relpath,
                line=node.lineno,
                message=(f"module-level device allocation bound to "
                         f"{', '.join(names)} lives for the process "
                         f"lifetime with no @capacity claim — "
                         f"unaccounted device residency"),
                context=f"{dotted}:{names[0]}:module-resident")))
    return out


def check_project(mods: Sequence[ModuleSource],
                  cg: Optional[cgmod.CallGraph] = None,
                  df: Optional[dfmod.DeviceDataflow] = None,
                  seen: Optional[Dict[str, int]] = None
                  ) -> List[Tuple[Optional[str], Finding]]:
    """The four families. ``seen`` counts the escape sites the residency
    analysis found (``residency_escape_sites``) and those a claim prices
    (``residency_priced_sites``)."""
    if df is None:
        df = dfmod.build(mods, cg)
    cg = df.cg
    seen = seen if seen is not None else {}
    ann = _CapacityAnnotations(cg)
    out: List[Tuple[Optional[str], Finding]] = []

    # (1) hbm-residency-budget (the dataflow already leaves the bodies
    # of torch transforms out: they retain nothing themselves)
    for key, esc in sorted(df.escapes.items()):
        fi = cg.funcs[key]
        seen["residency_escape_sites"] = \
            seen.get("residency_escape_sites", 0) + len(esc.stores)
        if ann.covers(cg, key):
            seen["residency_priced_sites"] = \
                seen.get("residency_priced_sites", 0) + len(esc.stores)
            continue
        for st in esc.stores:
            out.append((fi.relpath, Finding(
                rule="hbm-residency-budget", path=fi.relpath,
                line=st.line,
                message=(
                    f"{fi.qualname}: a device allocation escapes into "
                    f"the long-lived store {st.label} with no "
                    f"@capacity(bytes_per_sample=..., reason=...) "
                    f"claim on the function or its class — "
                    f"unaccounted device residency"),
                context=f"{fi.qualname}:resident:{st.label}")))
    out.extend(_module_resident(mods, df))
    # (2) device-buffer-leak
    out.extend(_check_leaks(cg, df, mods))
    # (3) oversized-transfer
    out.extend(_check_transfers(cg, df, mods, ann))
    # (4) smem-frontier-budget
    out.extend(_check_smem_frontier(mods, cg))
    return out
