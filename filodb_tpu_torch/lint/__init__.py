"""graftlint for the port: the static analyser of ``filodb_tpu_torch`` and
its declaration decorators.

The declaration modules (``threads``, ``locks``, ``caches``, ``hotpath``,
``contracts``, ``capacity``, ``numerics``) are pure Python and import
nothing at import time, so every module of the port can carry its
declarations. The analyser reads them by the decorator's leaf name
(``single_writer``, ``cache_registry``, ``capacity``, ...)::

    python -m filodb_tpu_torch.lint [paths] [--json|--github|--sarif]
                                    [--changed-only]

Rule families (see the rule modules for the catalog):

  * ``rules_kernel`` — every call into the CUDA kernel libraries that
    ``query/kernels.build_kernels`` loads sits inside a
    :func:`~filodb_tpu_torch.lint.contracts.kernel_contract`; each
    ``kind="cuda"`` contract's shared-memory budget, grid limits, int31
    span guard and outputs are checked on the CPU (the plain version run
    on ``device="meta"``, which computes nothing).
  * ``rules_capacity`` — device residency over the engine's torch taint
    (``dataflow.py``): a torch device allocation escaping into a
    long-lived store needs a ``@capacity`` claim, a registered store
    that accumulates device tensors needs an eviction path, a
    ``@hot_path`` function must not pull a whole resident channel to the
    host, and the group-sum's launch planner must keep every plan inside
    its contract's shared-memory budget (``smem-frontier-budget``).
  * ``memcert`` — every ``@capacity`` claim is built by its harness and
    its device bytes measured (a walk over distinct tensor storages; on
    CUDA also ``torch.cuda.memory_allocated``), two-sided against the
    claim.
  * ``rules_cache`` — cache-invalidation completeness over the
    ``@cache_registry`` inventory.
  * ``rules_lock`` / ``rules_concurrency`` — ``@guarded_by`` discipline,
    blocking calls under locks, lock-order cycles and the canonical order
    (``lockorder.py``), shared state mutated from two thread roots.
  * ``rules_hot`` / ``rules_span`` — device->host syncs (``.item()``,
    ``.cpu()``, ``torch.cuda.synchronize``, ...) and span formatting
    inside ``@hot_path`` functions.
  * ``rules_promql`` — the shipped rule files through the port's rules
    loader with semantic analysis, and a seeded engine-vs-``ref_eval``
    micro-soak.

Not ported yet (:data:`NOT_PORTED`): the SPMD family over
``torch.distributed`` and the partition collectives, trace safety of the
``torch.func.vmap`` bodies, and the static side of ``@precision``.

Mechanics:

  * suppress one finding: ``# graftlint: disable=<rule> (reason)`` on
    the offending line or the line above it. A reason string is
    required — bare disables are themselves a finding.
  * grandfather findings: ``filodb_tpu_torch/lint/baseline.json`` holds
    keys of known findings; the run fails only on NEW findings. The
    shipped baseline is empty — keep it that way.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import os
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

ERROR = "error"
WARNING = "warning"

# rule modules of the reference analyser that have no counterpart here
# yet, with what each would check
NOT_PORTED: Dict[str, str] = {
    "rules_spmd": "collective balance over torch.distributed and the "
                  "partition collectives of parallel/",
    "rules_trace": "side effects and captured-state mutation inside the "
                   "torch.func.vmap twins' bodies",
    "rules_numerics": "the static side of @precision (narrowing, "
                      "accumulation bounds, reduction order)",
}

_PRAGMA_RE = re.compile(
    r"#\s*graftlint:\s*disable=([\w\-,]+)\s*(?:\(([^)]*)\))?")


@dataclass(frozen=True)
class Finding:
    """One rule violation at a source location."""
    rule: str
    path: str               # repo-relative, forward slashes
    line: int
    message: str
    severity: str = ERROR
    context: str = ""       # enclosing qualname (stable across line drift)

    def key(self) -> str:
        """Stable identity for baseline matching: deliberately excludes
        the line number so unrelated edits don't churn the baseline."""
        return f"{self.path}::{self.rule}::{self.context or self.message}"

    def to_json(self) -> Dict:
        return dataclasses.asdict(self)

    def render(self) -> str:
        return (f"{self.path}:{self.line}: [{self.rule}] "
                f"{self.message}")


@dataclass(frozen=True)
class Rule:
    """One registered rule."""
    id: str
    family: str
    severity: str
    doc: str


_RULES: Dict[str, Rule] = {}


def register_rule(id: str, family: str, doc: str,
                  severity: str = ERROR) -> Rule:
    rule = Rule(id=id, family=family, severity=severity, doc=doc)
    _RULES[id] = rule
    return rule


def rules() -> Dict[str, Rule]:
    """The rule catalog (id -> Rule), importing all rule modules."""
    _load_rule_modules()
    return dict(_RULES)


register_rule(
    "pragma-no-reason", "meta",
    "a `# graftlint: disable=` pragma must carry a (reason) string")
register_rule(
    "pragma-unknown-rule", "meta",
    "a pragma disables a rule id that does not exist")


@dataclass
class ModuleSource:
    """Parsed view of one file handed to AST rules."""
    path: str               # absolute
    relpath: str            # repo-relative, forward slashes
    source: str
    tree: ast.Module
    lines: List[str]
    # line -> (set of disabled rule ids, reason or None)
    pragmas: Dict[int, Tuple[frozenset, Optional[str]]]


def _parse_pragmas(lines: Sequence[str]
                   ) -> Dict[int, Tuple[frozenset, Optional[str]]]:
    out: Dict[int, Tuple[frozenset, Optional[str]]] = {}
    for i, text in enumerate(lines, start=1):
        m = _PRAGMA_RE.search(text)
        if m:
            ids = frozenset(x.strip() for x in m.group(1).split(",")
                            if x.strip())
            out[i] = (ids, m.group(2))
    return out


def load_module(path: str, root: Optional[str] = None
                ) -> Optional[ModuleSource]:
    try:
        with open(path, "r", encoding="utf-8") as f:
            source = f.read()
        tree = ast.parse(source, filename=path)
    except (OSError, SyntaxError):
        return None
    rel = os.path.relpath(path, root) if root else path
    rel = rel.replace(os.sep, "/")
    lines = source.splitlines()
    return ModuleSource(path=path, relpath=rel, source=source, tree=tree,
                        lines=lines, pragmas=_parse_pragmas(lines))


def _suppressed(mod: ModuleSource, f: Finding) -> bool:
    """A finding is suppressed by a pragma on its line or the line
    directly above it naming its rule (or `all`)."""
    for ln in (f.line, f.line - 1):
        entry = mod.pragmas.get(ln)
        if entry and (f.rule in entry[0] or "all" in entry[0]):
            return True
    return False


def _pragma_findings(mod: ModuleSource) -> List[Finding]:
    out = []
    known = set(_RULES)
    for ln, (ids, reason) in mod.pragmas.items():
        if not reason or not reason.strip():
            out.append(Finding(
                rule="pragma-no-reason", path=mod.relpath, line=ln,
                message="disable pragma without a (reason) string",
                context=f"pragma:{','.join(sorted(ids))}"))
        for rid in ids:
            if rid != "all" and rid not in known:
                out.append(Finding(
                    rule="pragma-unknown-rule", path=mod.relpath, line=ln,
                    message=f"pragma disables unknown rule {rid!r}",
                    context=f"pragma:{rid}"))
    return out


# -- baseline ---------------------------------------------------------------

def baseline_path() -> str:
    return os.path.join(os.path.dirname(__file__), "baseline.json")


def load_baseline(path: Optional[str] = None) -> frozenset:
    path = path or baseline_path()
    try:
        with open(path, "r", encoding="utf-8") as f:
            data = json.load(f)
    except (OSError, ValueError):
        return frozenset()
    return frozenset(data.get("findings", []))


# -- runner -----------------------------------------------------------------

@dataclass
class LintResult:
    findings: List[Finding] = field(default_factory=list)   # new (fail)
    baselined: List[Finding] = field(default_factory=list)  # grandfathered
    suppressed: int = 0
    files: int = 0
    # what the families saw (sites checked, not findings): the evidence
    # that a clean run is not a vacuous one
    seen: Dict[str, int] = field(default_factory=dict)

    @property
    def errors(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == ERROR]

    def to_json(self) -> Dict:
        return {"files": self.files,
                "findings": [f.to_json() for f in self.findings],
                "baselined": [f.to_json() for f in self.baselined],
                "suppressed": self.suppressed,
                "seen": dict(sorted(self.seen.items())),
                "not_ported": sorted(NOT_PORTED),
                "exit_code": 1 if self.errors else 0}


def package_root() -> str:
    """Directory containing the ``filodb_tpu_torch`` package (the repo
    root when run from a checkout)."""
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def iter_py_files(paths: Sequence[str]) -> List[str]:
    out: List[str] = []
    for p in paths:
        if os.path.isfile(p):
            out.append(os.path.abspath(p))
        else:
            for dirpath, dirnames, filenames in os.walk(p):
                dirnames[:] = [d for d in dirnames
                               if d not in ("__pycache__",)]
                for fn in sorted(filenames):
                    if fn.endswith(".py"):
                        out.append(os.path.abspath(
                            os.path.join(dirpath, fn)))
    return out


_rule_modules_loaded = False


def _load_rule_modules() -> None:
    global _rule_modules_loaded
    if _rule_modules_loaded:
        return
    _rule_modules_loaded = True
    from filodb_tpu_torch.lint import (memcert,  # noqa: F401
                                       rules_cache, rules_capacity,
                                       rules_concurrency, rules_hot,
                                       rules_kernel, rules_lock,
                                       rules_promql, rules_span)


def run_lint(paths: Optional[Sequence[str]] = None, *,
             baseline: Optional[frozenset] = None,
             check_contracts: bool = True,
             report_only: Optional[frozenset] = None) -> LintResult:
    """Lint ``paths`` (default: the ``filodb_tpu_torch`` package).

    AST rules run per file; the interprocedural families run once over
    the whole module set on one call graph and one dataflow layer; when
    ``check_contracts`` is set, the modules that declare kernel contracts
    are imported and each contract is verified, and the capacity claims
    are certified (``memcert``, memoized per process).

    ``report_only`` (a set of repo-relative paths) keeps the analysis
    whole-program but drops findings anchored outside those files —
    the ``--changed-only`` pre-commit mode, which also skips the
    PromQL soak and the certification."""
    from filodb_tpu_torch.lint import astwalk
    astwalk.clear()     # fresh memoized-walk cache per run
    _load_rule_modules()
    from filodb_tpu_torch.lint import (rules_cache, rules_capacity,
                                       rules_concurrency, rules_hot,
                                       rules_kernel, rules_lock,
                                       rules_promql, rules_span)
    from filodb_tpu_torch.lint import callgraph as _cgmod
    from filodb_tpu_torch.lint import dataflow as _dfmod
    root = package_root()
    if paths is None:
        paths = [os.path.join(root, "filodb_tpu_torch")]
    if baseline is None:
        baseline = load_baseline()
    files = iter_py_files(paths)
    result = LintResult(files=len(files))
    mods: List[ModuleSource] = []
    for path in files:
        mod = load_module(path, root=root)
        if mod is None:
            continue
        mods.append(mod)
    # two passes: lock declarations are collected package-wide first so
    # cross-class (foreign-object) guarded accesses resolve
    lock_decls = rules_lock.collect_declarations(mods)
    raw: List[Tuple[Optional[ModuleSource], Finding]] = []
    seen: Dict[str, int] = {}
    for mod in mods:
        for f in _pragma_findings(mod):
            raw.append((mod, f))
        for f in rules_kernel.check_module(mod, seen):
            raw.append((mod, f))
        for f in rules_hot.check_module(mod):
            raw.append((mod, f))
        for f in rules_span.check_module(mod):
            raw.append((mod, f))
        for f in rules_lock.check_module(mod, lock_decls):
            raw.append((mod, f))
    bymod = {m.relpath: m for m in mods}
    # one call graph + one dataflow layer shared by every
    # interprocedural family
    cg = _cgmod.build(mods)
    df = _dfmod.DeviceDataflow(mods, cg)
    for relpath, f in rules_concurrency.check_project(mods, cg=cg):
        raw.append((bymod.get(relpath), f))
    for relpath, f in rules_cache.check_project(mods, cg=cg, df=df):
        raw.append((bymod.get(relpath), f))
    for relpath, f in rules_capacity.check_project(mods, cg=cg, df=df,
                                                   seen=seen):
        raw.append((bymod.get(relpath), f))
    for relpath, f in rules_promql.check_project(
            mods, root, skip_soak=report_only is not None):
        raw.append((bymod.get(relpath), f))
    if check_contracts:
        for relpath, f in rules_kernel.check_contracts(mods, root, seen):
            raw.append((bymod.get(relpath), f))
        if report_only is None:
            from filodb_tpu_torch.lint import memcert
            for relpath, f in memcert.check_certifications(mods):
                raw.append((bymod.get(relpath), f))
    result.seen = seen
    for mod, f in raw:
        if mod is not None and _suppressed(mod, f):
            result.suppressed += 1
        elif report_only is not None and f.path not in report_only:
            continue
        elif f.key() in baseline:
            result.baselined.append(f)
        else:
            result.findings.append(f)
    result.findings.sort(key=lambda f: (f.path, f.line, f.rule))
    result.baselined.sort(key=lambda f: (f.path, f.line, f.rule))
    return result
