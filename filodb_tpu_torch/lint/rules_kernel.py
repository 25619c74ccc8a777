"""Kernel-contract rules for the port's CUDA kernels.

AST side: every call into the kernel libraries that
``query/kernels.build_kernels`` compiles and loads (a ctypes entry point
``*_launch`` of a library bound from ``build_kernels()``) must sit inside
a function (or a lexically enclosing function) decorated with
:func:`filodb_tpu_torch.lint.contracts.kernel_contract`.

Runtime side (CPU only — no kernel is launched, nothing is compiled):
every registered contract is re-verified from its declaration:

  * ``kernel-contract-missing`` — a kernel-library call with no
    enclosing contract declaration.
  * ``kernel-smem-budget`` — a CUDA contract declares no shared-memory
    budget, a budget past the opt-in limit of a block
    (:data:`~filodb_tpu_torch.lint.contracts.SMEM_OPTIN_BYTES`), or a
    launch of its plan at a declared workload whose static plus dynamic
    shared memory exceeds the budget.
  * ``kernel-grid-bounds`` — a launch of the plan at a declared workload
    with a grid outside x < 2^31, y and z <= 65,535, more threads than
    the block declares, or registers past one SM's file.
  * ``kernel-span-guard`` — a contract declares int31 relative
    timestamps but names no resolvable dispatcher predicate proving the
    span fits.
  * ``kernel-abstract-eval`` — the contract's example, run through the
    plain version on ``device="meta"`` (shapes and dtypes, no data;
    eager contracts run theirs on the CPU), fails or disagrees with the
    declared outputs.
  * ``kernel-module-import`` — a kernel module failed to import, so its
    contracts could not be checked.

Card side (no rule; chip_smoke's phase 15 runs them where the libraries
are built and loaded): :func:`check_build` holds a CUDA contract's
declared registers and static shared bytes to nvcc's ptxas report
(:func:`ptxas_report`, kept beside each library, so a reused build reads
the same report) and to the functions' attributes as the card loaded
them, and its budget to the card's opt-in limit; :func:`check_launches`
holds what a library reports it launches for one call's shape to the
contract's plan and to :meth:`KernelContract.admits`.
"""

from __future__ import annotations

import ast
import importlib
import inspect
import re
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from filodb_tpu_torch.lint import Finding, ModuleSource, register_rule
from filodb_tpu_torch.lint.astwalk import walk_nodes
from filodb_tpu_torch.lint.contracts import (SMEM_OPTIN_BYTES,
                                             KernelContract, Launch,
                                             check_contract,
                                             contracts_for_module)

register_rule("kernel-contract-missing", "kernel",
              "call into a build_kernels() kernel library without an "
              "enclosing @kernel_contract declaration")
register_rule("kernel-smem-budget", "kernel",
              "a CUDA contract's shared-memory budget is missing or past "
              "the block's opt-in limit, or its plan asks more")
register_rule("kernel-grid-bounds", "kernel",
              "a launch of the contract's plan has a grid, block or "
              "register count outside the card's limits")
register_rule("kernel-span-guard", "kernel",
              "int31 relative-timestamp kernel without a resolvable "
              "dispatcher span guard")
register_rule("kernel-abstract-eval", "kernel",
              "the contract's example through the plain version on the "
              "meta device fails or disagrees with the declared outputs")
register_rule("kernel-module-import", "kernel",
              "kernel module failed to import; contracts unchecked")

# the loader of the kernel libraries and the suffix of their entry points
_LIB_LOADERS = frozenset({"build_kernels"})
_ENTRY_SUFFIX = "_launch"


def _is_kernel_contract_deco(d: ast.expr) -> bool:
    target = d.func if isinstance(d, ast.Call) else d
    if isinstance(target, ast.Attribute):
        return target.attr == "kernel_contract"
    return isinstance(target, ast.Name) and target.id == "kernel_contract"


def _has_contract(stack: List[ast.AST]) -> bool:
    for node in stack:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if any(_is_kernel_contract_deco(d) for d in node.decorator_list):
                return True
    return False


def _loads_library(e) -> bool:
    """``e`` mentions a call of the kernel-library loader."""
    for n in ast.walk(e):
        if isinstance(n, ast.Call):
            f = n.func
            leaf = f.attr if isinstance(f, ast.Attribute) else \
                f.id if isinstance(f, ast.Name) else None
            if leaf in _LIB_LOADERS:
                return True
    return False


def _library_names(fn) -> Set[str]:
    """Locals of ``fn`` bound to a loaded kernel library."""
    out: Set[str] = set()
    for node in walk_nodes(fn):
        if isinstance(node, ast.Assign) and _loads_library(node.value):
            out.update(t.id for t in node.targets
                       if isinstance(t, ast.Name))
    return out


def _is_library_call(node: ast.Call, libs: Set[str]) -> bool:
    f = node.func
    if not isinstance(f, ast.Attribute) \
            or not f.attr.endswith(_ENTRY_SUFFIX):
        return False
    recv = f.value
    if isinstance(recv, ast.Name):
        return recv.id in libs
    return _loads_library(recv)


def check_module(mod: ModuleSource,
                 seen: Optional[Dict[str, int]] = None
                 ) -> Iterable[Finding]:
    """AST pass: kernel-library calls must carry a contract. Counts the
    sites in ``seen`` (``kernel_launch_sites`` and
    ``kernel_launch_sites_under_contract``)."""
    findings: List[Finding] = []
    seen = seen if seen is not None else {}
    libs_by_fn: Dict[int, Set[str]] = {}

    def libs_in(stack) -> Set[str]:
        out: Set[str] = set()
        for n in stack:
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if id(n) not in libs_by_fn:
                    libs_by_fn[id(n)] = _library_names(n)
                out |= libs_by_fn[id(n)]
        return out

    def walk(node: ast.AST, stack: List[ast.AST]) -> None:
        if isinstance(node, ast.Call) \
                and _is_library_call(node, libs_in(stack)):
            seen["kernel_launch_sites"] = \
                seen.get("kernel_launch_sites", 0) + 1
            if _has_contract(stack):
                seen["kernel_launch_sites_under_contract"] = \
                    seen.get("kernel_launch_sites_under_contract", 0) + 1
            else:
                qual = ".".join(
                    n.name for n in stack
                    if isinstance(n, (ast.FunctionDef, ast.ClassDef)))
                findings.append(Finding(
                    rule="kernel-contract-missing", path=mod.relpath,
                    line=node.lineno,
                    message=f"kernel-library call {node.func.attr}() has "
                            f"no enclosing @kernel_contract declaration",
                    context=qual or "<module>"))
        stack.append(node)
        for child in ast.iter_child_nodes(node):
            walk(child, stack)
        stack.pop()

    walk(mod.tree, [])
    return findings


# -- runtime contract verification ------------------------------------------

def _contract_line(c: KernelContract) -> int:
    try:
        return inspect.getsourcelines(inspect.unwrap(c.fn))[1]
    except (OSError, TypeError):
        return 1


def _finding(c: KernelContract, relpath: str, rule: str, check: str,
             message: str) -> Finding:
    return Finding(rule=rule, path=relpath, line=_contract_line(c),
                   message=f"contract {c.name!r}: {message}",
                   context=f"contract:{c.name}:{check}")


def _check_cuda(c: KernelContract, relpath: str) -> List[Finding]:
    out: List[Finding] = []
    if c.smem_budget is None:
        out.append(_finding(c, relpath, "kernel-smem-budget", "declared",
                            "CUDA kernel declares no shared-memory budget"))
    elif c.smem_budget > SMEM_OPTIN_BYTES:
        out.append(_finding(
            c, relpath, "kernel-smem-budget", "physical",
            f"budget {c.smem_budget} B exceeds a block's opt-in shared "
            f"memory {SMEM_OPTIN_BYTES} B"))
    if not c.kernels or c.launches is None or not c.workloads:
        out.append(_finding(
            c, relpath, "kernel-grid-bounds", "declared",
            "CUDA contract declares no kernels, launch plan or "
            "workloads"))
        return out
    for i, w in enumerate(c.workloads):
        try:
            plan = list(c.launches(**w))
        except Exception as e:      # noqa: BLE001 — report, don't crash
            out.append(_finding(
                c, relpath, "kernel-grid-bounds", f"plan:{i}",
                f"launch plan raises at workload {w}: "
                f"{type(e).__name__}: {e}"))
            continue
        for launch in plan:
            why = c.admits(launch)
            if why is None:
                continue
            rule = "kernel-smem-budget" if "shared memory" in why \
                else "kernel-grid-bounds"
            out.append(_finding(c, relpath, rule,
                                f"{launch.kernel}:{i}",
                                f"at workload {w}: {why}"))
    return out


def _check_span_guard(c: KernelContract, relpath: str) -> List[Finding]:
    """``name`` resolves in the contract's module, ``pkg.mod:name`` in
    the named module (guards usually live in the dispatcher, not next to
    the kernel)."""
    if c.rel_time_bits is None:
        return []
    ok = False
    if c.span_guard:
        modname, _, attr = c.span_guard.rpartition(":")
        modname = modname or c.module
        try:
            target = importlib.import_module(modname)
            for part in attr.split("."):
                target = getattr(target, part)
            ok = callable(target)
        except (ImportError, AttributeError):
            ok = False
    if ok:
        return []
    return [_finding(
        c, relpath, "kernel-span-guard", "guard",
        f"declares int{c.rel_time_bits} relative timestamps but span "
        f"guard {c.span_guard!r} does not resolve to a callable in "
        f"{c.module}")]


def check_contract_decl(c: KernelContract,
                        relpath: str = "") -> List[Finding]:
    """Verify one contract declaration on the CPU."""
    relpath = relpath or (c.module.replace(".", "/") + ".py")
    out: List[Finding] = []
    if c.kind == "cuda":
        out.extend(_check_cuda(c, relpath))
    out.extend(_check_span_guard(c, relpath))
    if c.check is not None or c.example is not None:
        device = "meta" if c.kind == "cuda" else "cpu"
        try:
            err = check_contract(c, device)
        except Exception as e:      # noqa: BLE001 — report, don't crash
            err = f"{type(e).__name__}: {e}"
        if err:
            out.append(_finding(c, relpath, "kernel-abstract-eval",
                                device, str(err)))
    elif c.kind == "cuda":
        out.append(_finding(c, relpath, "kernel-abstract-eval", "meta",
                            "CUDA contract declares no example"))
    return out


def _module_name(relpath: str) -> Optional[str]:
    if not relpath.endswith(".py"):
        return None
    parts = relpath[:-3].split("/")
    if parts and parts[-1] == "__init__":
        parts = parts[:-1]
    if not parts or parts[0] != "filodb_tpu_torch":
        return None
    return ".".join(parts)


def check_contracts(mods, root: str,
                    seen: Optional[Dict[str, int]] = None
                    ) -> Iterable[Tuple[str, Finding]]:
    """Import every linted package module that declares a contract and
    verify the contracts it registered; ``seen["cuda_contracts"]`` counts
    the CUDA ones."""
    out: List[Tuple[str, Finding]] = []
    seen = seen if seen is not None else {}
    for mod in mods:
        name = _module_name(mod.relpath)
        if name is None or "kernel_contract" not in mod.source \
                or name == "filodb_tpu_torch.lint.contracts":
            continue
        try:
            importlib.import_module(name)
        except Exception as e:      # noqa: BLE001 — surface, don't crash
            out.append((mod.relpath, Finding(
                rule="kernel-module-import", path=mod.relpath, line=1,
                message=f"import failed, contracts unchecked: "
                        f"{type(e).__name__}: {e}",
                context=f"import:{name}")))
            continue
        for c in contracts_for_module(name):
            if c.kind == "cuda":
                seen["cuda_contracts"] = seen.get("cuda_contracts", 0) + 1
            for f in check_contract_decl(c, mod.relpath):
                out.append((mod.relpath, f))
    return out


# -- card side ---------------------------------------------------------------

def ptxas_report(log_text: str) -> Dict[str, Dict[str, int]]:
    """ptxas -v's report per entry function (mangled name) -> registers
    and static shared bytes."""
    out: Dict[str, Dict[str, int]] = {}
    fn = None
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            fn = m.group(1)
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and fn is not None:
            sm = re.search(r"(\d+) bytes smem", line)
            out[fn] = {"registers": int(m.group(1)),
                       "static_smem": int(sm.group(1)) if sm else 0}
            fn = None
    return out


def check_build(c: KernelContract, report: Dict[str, Dict[str, int]],
                attrs: Sequence[Tuple[str, int, int, int]],
                smem_optin: int) -> Tuple[dict, List[str]]:
    """Hold one CUDA contract to its build on the card -> (per declared
    kernel: its instances and what ptxas and the card say of them, the
    mismatches). ``report`` is :func:`ptxas_report` of the library's
    build, ``attrs`` (name, registers, static shared bytes, most threads
    per block) per ``__global__`` instance as cudaFuncGetAttributes reads
    it on the card, ``smem_optin`` the card's opt-in shared memory per
    block. Every instance in either source must belong to a declared
    kernel, and each declared kernel's registers and static shared bytes
    (the most over its instances) must equal both sources'."""
    bad: List[str] = []
    seen: dict = {}
    names = [k.name for k in c.kernels]
    for fn in report:
        if not any(n in fn for n in names):
            bad.append(f"ptxas reports undeclared kernel {fn}")
    for name, *_ in attrs:
        if name not in names:
            bad.append(f"the library holds undeclared kernel {name}")
    for k in c.kernels:
        px = [v for fn, v in report.items() if k.name in fn]
        card = [a for a in attrs if a[0] == k.name]
        row = {"declared_registers": k.registers,
               "declared_static_smem": k.static_smem,
               "threads": k.threads,
               "ptxas_instances": len(px), "card_instances": len(card)}
        seen[k.name] = row
        if not px:
            bad.append(f"ptxas reports no {k.name}")
        if not card:
            bad.append(f"the library reports no {k.name}")
        if not px or not card:
            continue
        row.update(
            ptxas_registers=max(v["registers"] for v in px),
            ptxas_static_smem=max(v["static_smem"] for v in px),
            card_registers=max(a[1] for a in card),
            card_static_smem=max(a[2] for a in card),
            card_max_threads=min(a[3] for a in card))
        for src in ("ptxas", "card"):
            regs, smem = row[f"{src}_registers"], row[f"{src}_static_smem"]
            if (regs, smem) != (k.registers, k.static_smem):
                bad.append(f"{k.name}: {src} {regs} registers / {smem} B "
                           f"static shared memory, declared "
                           f"{k.registers} / {k.static_smem}")
        if row["card_max_threads"] < k.threads:
            bad.append(f"{k.name}: the card takes at most "
                       f"{row['card_max_threads']} threads a block, "
                       f"declared {k.threads}")
    if c.smem_budget is None or c.smem_budget > smem_optin:
        bad.append(f"budget {c.smem_budget} past the card's opt-in "
                   f"shared memory {smem_optin}")
    return seen, bad


def check_launches(c: KernelContract, shape: dict,
                   launched: Sequence[Launch]) -> List[str]:
    """Hold what a kernel library reports it launches for one call's
    ``shape`` (the contract's ``launches`` keywords) to the contract: the
    same launches as its plan, each admitted."""
    bad: List[str] = []
    planned = list(c.launches(**shape))
    if list(launched) != planned:
        bad.append(f"at {shape} the library launches {list(launched)}, "
                   f"the plan says {planned}")
    for launch in launched:
        why = c.admits(launch)
        if why:
            bad.append(f"at {shape}: {why}")
    return bad
