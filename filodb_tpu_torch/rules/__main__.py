"""``python -m filodb_tpu_torch.rules --check <file>``: promtool-style rule
file validation — structural checks, PromQL syntax through the NORMAL
parser (no second grammar to drift), promlint semantic analysis
(type/schema checking, label dataflow — spanned diagnostics), and
normalized duplicate-rule detection. Exit 0 = clean (warnings may
print); exit 1 = errors (printed one per line); exit 2 = usage."""

from __future__ import annotations

import argparse
import sys

from filodb_tpu_torch.rules.loader import (check_rules_file_full,
                                           load_rules_file)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m filodb_tpu_torch.rules")
    p.add_argument("--check", metavar="FILE",
                   help="validate a rule file and exit")
    args = p.parse_args(argv)
    if not args.check:
        p.print_usage(sys.stderr)
        return 2
    errors, warnings = check_rules_file_full(args.check)
    for w in warnings:
        print(f"{args.check}: warning: {w}")
    if errors:
        for e in errors:
            print(f"{args.check}: {e}")
        return 1
    groups = load_rules_file(args.check)
    n_rules = sum(len(g.rules) for g in groups)
    print(f"{args.check}: OK — {len(groups)} group(s), "
          f"{n_rules} rule(s)"
          + (f", {len(warnings)} warning(s)" if warnings else ""))
    return 0


if __name__ == "__main__":
    sys.exit(main())
