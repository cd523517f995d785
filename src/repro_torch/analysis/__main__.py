"""CLI: ``python -m repro_torch.analysis [paths...] [--strict]``.

Exit status 0 only when no finding survives suppression.  The default path
is the port's package, ``src/repro_torch/``.
"""
from __future__ import annotations

import argparse
import sys

from .base import RULE_DOCS, analyze_paths, load_suppression_file, \
    register_rules

DEFAULT_PATHS = ["src/repro_torch/"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="AST-driven consistency-contract checker of the port")
    ap.add_argument("paths", nargs="*", default=DEFAULT_PATHS,
                    help="files or directories to scan (default: "
                         "src/repro_torch/)")
    ap.add_argument("--strict", action="store_true",
                    help="also reject `# analysis: ignore[...]` comments "
                         "written without a reason")
    ap.add_argument("--suppressions", default=None,
                    help="repo-level suppression file (lines of "
                         "`path-glob:rule-id`)")
    ap.add_argument("--no-model-check", action="store_true",
                    help="skip the staleness model checker")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalog and exit")
    args = ap.parse_args(argv)

    if args.list_rules:
        register_rules()
        width = max(len(r) for r in RULE_DOCS)
        for rule_id in sorted(RULE_DOCS):
            print(f"{rule_id:<{width}}  {RULE_DOCS[rule_id]}")
        return 0

    supp = (load_suppression_file(args.suppressions)
            if args.suppressions else None)
    findings = analyze_paths(args.paths or DEFAULT_PATHS,
                             strict=args.strict, suppressions=supp,
                             model_check=not args.no_model_check)
    for f in findings:
        print(f)
    n = len(findings)
    mode = " (strict)" if args.strict else ""
    print(f"repro_torch.analysis{mode}: "
          f"{n} finding{'s' if n != 1 else ''}")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
