"""``python -m filodb_tpu_torch.lint`` — run the port's graftlint.

Exit codes: 0 = clean (no new error-severity findings), 1 = findings,
2 = usage error.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from typing import Optional

from filodb_tpu_torch.lint import load_baseline, package_root, rules, run_lint


def changed_files(base: Optional[str] = None) -> frozenset:
    """Repo-relative .py paths changed vs ``base`` (default: the
    working tree + index vs HEAD — the pre-commit view). Paths are
    normalized to the forward-slash relpath form findings use."""
    root = package_root()
    out = set()
    cmds = [["git", "diff", "--name-only", base]] if base else \
        [["git", "diff", "--name-only", "HEAD"],
         ["git", "diff", "--name-only", "--cached"],
         ["git", "ls-files", "--others", "--exclude-standard"]]
    for cmd in cmds:
        try:
            text = subprocess.run(
                cmd, cwd=root, capture_output=True, text=True,
                check=True).stdout
        except (OSError, subprocess.CalledProcessError):
            continue
        for line in text.splitlines():
            line = line.strip().replace(os.sep, "/")
            if line.endswith(".py"):
                out.add(line)
    return frozenset(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m filodb_tpu_torch.lint",
        description="graftlint of the port: CUDA kernel-contract, "
                    "device-residency and capacity, SPMD and in-place "
                    "write, numeric-precision, trace-safety, "
                    "lock-discipline, cache-invalidation, hot-path and "
                    "PromQL-surface (promlint) static analysis")
    ap.add_argument("paths", nargs="*",
                    help="files/directories to lint (default: the "
                         "filodb_tpu_torch package)")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="emit machine-readable findings on stdout")
    ap.add_argument("--github", action="store_true", dest="as_github",
                    help="emit GitHub workflow ::error/::warning "
                         "annotation lines (CI inline PR comments)")
    ap.add_argument("--sarif", action="store_true", dest="as_sarif",
                    help="emit a SARIF 2.1.0 report on stdout (all "
                         "rule families in the tool driver) for "
                         "code-scanning UIs")
    ap.add_argument("--baseline", default=None,
                    help="baseline file (default: the shipped "
                         "filodb_tpu_torch/lint/baseline.json)")
    ap.add_argument("--no-contracts", action="store_true",
                    help="skip runtime kernel-contract verification "
                         "and the ulp and capacity certifications (AST "
                         "rules only)")
    ap.add_argument("--changed-only", action="store_true",
                    help="report only findings anchored in files git "
                         "considers changed (working tree + index vs "
                         "HEAD, or vs --diff-base); the interprocedural "
                         "rules still analyze the whole graph")
    ap.add_argument("--diff-base", default=None,
                    help="git ref to diff against for --changed-only "
                         "(default: HEAD incl. staged + untracked)")
    ap.add_argument("--rules", action="store_true", dest="list_rules",
                    help="print the rule catalog and exit")
    args = ap.parse_args(argv)

    if args.list_rules:
        for rid, rule in sorted(rules().items()):
            print(f"{rid:26s} [{rule.family}/{rule.severity}] {rule.doc}")
        return 0

    report_only = None
    if args.changed_only:
        report_only = changed_files(args.diff_base)
        if not report_only:
            print("graftlint: --changed-only: no changed .py files",
                  file=sys.stderr)
            return 0
    result = run_lint(args.paths or None,
                      baseline=load_baseline(args.baseline),
                      check_contracts=not args.no_contracts,
                      report_only=report_only)
    if args.as_github:
        from filodb_tpu_torch.lint.ci_annotations import github_annotations
        for line in github_annotations(result.to_json()):
            print(line)
        print(f"graftlint: {result.files} file(s), "
              f"{len(result.errors)} error(s)", file=sys.stderr)
    elif args.as_sarif:
        from filodb_tpu_torch.lint.ci_annotations import sarif_report
        print(json.dumps(sarif_report(result.to_json()), indent=2,
                         sort_keys=True))
        print(f"graftlint: {result.files} file(s), "
              f"{len(result.errors)} error(s)", file=sys.stderr)
    elif args.as_json:
        print(json.dumps(result.to_json(), indent=2, sort_keys=True))
    else:
        for f in result.findings:
            print(f.render())
        for f in result.baselined:
            print(f"{f.render()}  (baselined)")
        status = "clean" if not result.errors else \
            f"{len(result.errors)} error(s)"
        print(f"graftlint: {result.files} file(s), {status}, "
              f"{len(result.baselined)} baselined, "
              f"{result.suppressed} suppressed", file=sys.stderr)
    return 1 if result.errors else 0


if __name__ == "__main__":
    sys.exit(main())
