"""Interprocedural concurrency rules (graftlint v2).

Built on the project call graph (``lint/callgraph.py``), which
propagates held-lock sets across calls, discovers thread roots
(``Thread(target=...)``, executor ``.submit``, ``@thread_root``), and
summarizes blocking behavior transitively. Three families:

  * ``lock-order-cycle`` — the observed acquisition-order graph (lock A
    held while lock B is acquired, across all call paths) contains a
    cycle: two threads taking the locks in opposite orders deadlock.
    Reported once per cycle, anchored at one of its acquisition sites.
  * ``lock-order-policy`` — an observed pair contradicts the declared
    canonical order in ``lint/lockorder.py`` (outermost-first). Fires
    even while the order graph is still acyclic: the policy is what
    keeps it acyclic as code grows.
  * ``lock-blocking-reachable`` — a call made while holding a lock
    transitively reaches a blocking primitive (peer RPC / urlopen,
    fsync, device sync, sleep, unbounded ``Queue.get`` / ``Event.wait``,
    ``Future.result``) any number of frames down. The per-function rule
    (``lock-blocking-call``) catches the same-frame case; this one
    reports at the call site in the lock-holding function with the
    chain to the primitive.
  * ``thread-unguarded-shared-state`` — an instance attribute or module
    global is compound-mutated (append/pop/setitem/del/augassign/
    read-modify-write — NOT the GIL-atomic single-rebind publish idiom)
    from two or more thread roots, with no lock held in common across
    all mutation sites and no ``@guarded_by`` declaration. This infers
    MISSING annotations instead of only checking declared ones.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from filodb_tpu_torch.lint import Finding, ModuleSource, register_rule
from filodb_tpu_torch.lint import callgraph as cgmod
from filodb_tpu_torch.lint.lockorder import policy_violation

register_rule("lock-order-cycle", "concurrency",
              "lock acquisition-order graph contains a cycle "
              "(potential deadlock)")
register_rule("lock-order-policy", "concurrency",
              "lock pair acquired against the canonical order "
              "(lint/lockorder.py)")
register_rule("lock-blocking-reachable", "concurrency",
              "a blocking primitive is reachable through calls made "
              "while a lock is held")
register_rule("thread-unguarded-shared-state", "concurrency",
              "state compound-mutated from >=2 thread roots with no "
              "common lock and no @guarded_by")


def _fmt_chain(cg: cgmod.CallGraph,
               chain: Sequence[Tuple[str, int]]) -> str:
    parts = []
    for key, line in chain:
        fi = cg.funcs.get(key)
        if fi is None:
            continue
        parts.append(f"{fi.qualname} ({fi.relpath}:{line})")
    return " -> ".join(parts)


# -- lock order --------------------------------------------------------------

def _cycles(pairs: Dict[Tuple[str, str], Tuple[str, int, Tuple[str, ...]]]
            ) -> List[Tuple[str, ...]]:
    """Strongly connected components of size >= 2 in the order graph."""
    succ: Dict[str, Set[str]] = {}
    for (a, b) in pairs:
        succ.setdefault(a, set()).add(b)
        succ.setdefault(b, set())
    index: Dict[str, int] = {}
    low: Dict[str, int] = {}
    on: Set[str] = set()
    stack: List[str] = []
    out: List[Tuple[str, ...]] = []
    counter = [0]

    def strong(v: str) -> None:     # iterative Tarjan
        work = [(v, iter(sorted(succ.get(v, ()))))]
        index[v] = low[v] = counter[0]
        counter[0] += 1
        stack.append(v)
        on.add(v)
        while work:
            node, it = work[-1]
            advanced = False
            for w in it:
                if w not in index:
                    index[w] = low[w] = counter[0]
                    counter[0] += 1
                    stack.append(w)
                    on.add(w)
                    work.append((w, iter(sorted(succ.get(w, ())))))
                    advanced = True
                    break
                if w in on:
                    low[node] = min(low[node], index[w])
            if advanced:
                continue
            work.pop()
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[node])
            if low[node] == index[node]:
                comp = []
                while True:
                    w = stack.pop()
                    on.discard(w)
                    comp.append(w)
                    if w == node:
                        break
                if len(comp) >= 2:
                    out.append(tuple(sorted(comp)))

    for v in sorted(succ):
        if v not in index:
            strong(v)
    return out


def _check_lock_order(cg: cgmod.CallGraph) -> Iterable[Finding]:
    pairs = cg.order_pairs()
    findings: List[Finding] = []
    for cyc in _cycles(pairs):
        # anchor at the first in-cycle acquisition we observed
        anchor = None
        detail = []
        cyc_set = set(cyc)
        for (a, b), (fkey, line, chain) in sorted(pairs.items()):
            if a in cyc_set and b in cyc_set:
                fi = cg.funcs[fkey]
                via = f" via {chain[0]}" if chain else ""
                detail.append(f"{a} -> {b} at {fi.qualname} "
                              f"({fi.relpath}:{line}){via}")
                if anchor is None:
                    anchor = (fi, line)
        if anchor is None:
            continue
        fi, line = anchor
        findings.append(Finding(
            rule="lock-order-cycle", path=fi.relpath, line=line,
            message=(f"lock-order cycle among {', '.join(cyc)}: "
                     + "; ".join(detail[:4])),
            context=f"cycle:{'|'.join(cyc)}"))
    for (a, b), (fkey, line, chain) in sorted(pairs.items()):
        msg = policy_violation(a, b)
        if msg is None:
            continue
        fi = cg.funcs[fkey]
        via = f" ({a} held via {chain[0]})" if chain else ""
        findings.append(Finding(
            rule="lock-order-policy", path=fi.relpath, line=line,
            message=f"{fi.qualname} {msg}{via}",
            context=f"{fi.qualname}:{a}->{b}"))
    return findings


# -- blocking under lock, interprocedural ------------------------------------

def _check_blocking_reachable(cg: cgmod.CallGraph) -> Iterable[Finding]:
    findings: List[Finding] = []
    seen: Set[Tuple[str, int, str]] = set()
    for fi in cg.funcs.values():
        for s in fi.sites:
            if s.kind != "call" or not s.held or s.blocking:
                continue        # same-frame primitive: rules_lock's job
            for c in s.callees:
                summary = cg.blocks.get(c)
                if summary is None:
                    continue
                label, chain = summary
                locks = ", ".join(sorted(s.held))
                key = (fi.key, s.line, c)
                if key in seen:
                    continue
                seen.add(key)
                findings.append(Finding(
                    rule="lock-blocking-reachable", path=fi.relpath,
                    line=s.line,
                    message=(f"{fi.qualname} calls "
                             f"{cg.funcs[c].qualname} while holding "
                             f"{locks}; it reaches {label}: "
                             f"{_fmt_chain(cg, chain)}"),
                    context=f"{fi.qualname}:{c}:{label}"))
                break       # one finding per call site is enough
    return findings


# -- unguarded shared state --------------------------------------------------

def _check_shared_state(cg: cgmod.CallGraph) -> Iterable[Finding]:
    # func key -> roots that reach it on their own thread
    roots_of: Dict[str, Set[str]] = {}
    for r, reach in cg.reachable_from.items():
        for f in reach:
            roots_of.setdefault(f, set()).add(r)
    # target -> [(root display, FuncInfo, Mutation, full held)]
    by_target: Dict[str, List[Tuple[str, cgmod.FuncInfo, cgmod.Mutation,
                                    frozenset]]] = {}
    for fi in cg.funcs.values():
        if not fi.mutations:
            continue
        roots = roots_of.get(fi.key, set())
        if not roots:
            continue
        must = cg.must_held.get(fi.key, frozenset())
        for m in fi.mutations:
            full = frozenset(m.held | must)
            for r in roots:
                by_target.setdefault(m.target, []).append(
                    (cg.roots[r], fi, m, full))
    findings: List[Finding] = []
    for target, sites in sorted(by_target.items()):
        root_names = {r for r, _, _, _ in sites}
        if len(root_names) < 2:
            continue
        if cg.guarded_decl(target) is not None:
            continue        # declared: rules_lock enforces it
        if cg.single_writer_decl(target) is not None:
            # instances are owned by ONE thread at a time by design
            # (per-shard single-writer invariant); the class-level
            # abstraction cannot see instance disjointness
            continue
        common = None
        for _, _, _, full in sites:
            common = set(full) if common is None else (common & full)
        if common:
            continue        # a common guard exists at every site
        # report at the first mutation site (stable, suppressible)
        sites.sort(key=lambda t: (t[1].relpath, t[2].line))
        _, fi, m, _ = sites[0]
        locs = []
        seen_locs: Set[Tuple[str, int]] = set()
        for r, sfi, sm, _ in sites:
            lk = (sfi.relpath, sm.line)
            if lk in seen_locs:
                continue
            seen_locs.add(lk)
            locs.append(f"{sfi.qualname} ({sfi.relpath}:{sm.line}, "
                        f"root {r})")
        findings.append(Finding(
            rule="thread-unguarded-shared-state", path=fi.relpath,
            line=m.line,
            message=(f"{target} is compound-mutated from "
                     f"{len(root_names)} thread roots "
                     f"({', '.join(sorted(root_names))}) with no common "
                     f"lock and no @guarded_by: "
                     + "; ".join(locs[:4])),
            context=f"shared:{target}"))
    return findings


# -- entry point -------------------------------------------------------------

def check_project(mods: Sequence[ModuleSource],
                  cg: Optional[cgmod.CallGraph] = None
                  ) -> List[Tuple[Optional[str], Finding]]:
    """Run all three families over the module set. Returns
    (relpath, finding) pairs so the runner can route pragma
    suppression to the right file. ``cg`` lets the runner share one
    call graph across the interprocedural families."""
    if cg is None:
        cg = cgmod.build(mods)
    out: List[Tuple[Optional[str], Finding]] = []
    for f in _check_lock_order(cg):
        out.append((f.path, f))
    for f in _check_blocking_reachable(cg):
        out.append((f.path, f))
    for f in _check_shared_state(cg):
        out.append((f.path, f))
    return out
