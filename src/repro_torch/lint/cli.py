"""Command line for the determinism linter (``python -m repro_torch.lint``)."""
from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from repro_torch.lint.core import REGISTRY, lint_paths, make_rules, render_json


def _split_ids(value: Optional[str]) -> Optional[List[str]]:
    if not value:
        return None
    return [v.strip() for v in value.split(",") if v.strip()]


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.lint",
        description="repo-specific determinism/invariant linter")
    parser.add_argument("paths", nargs="*", default=["src"],
                        help="files or directories to lint (default: src)")
    parser.add_argument("--json", action="store_true",
                        help="emit the stable machine-readable report")
    parser.add_argument("--check", action="store_true",
                        help="CI mode: same as default (exit 1 on any "
                             "finding), kept explicit for pipelines")
    parser.add_argument("--select", metavar="IDS",
                        help="comma-separated rule ids to run exclusively")
    parser.add_argument("--ignore", metavar="IDS",
                        help="comma-separated rule ids to skip")
    parser.add_argument("--list-rules", action="store_true",
                        help="print registered rules and exit")
    args = parser.parse_args(argv)

    if args.list_rules:
        for rule in make_rules():
            print(f"{rule.rule_id}  {rule.title}")
        return 0

    select, ignore = _split_ids(args.select), _split_ids(args.ignore)
    try:
        findings = lint_paths(args.paths, select=select, ignore=ignore)
    except ValueError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2

    if args.json:
        print(render_json(findings, make_rules(select, ignore)))
    else:
        for f in findings:
            print(f.render())
        if findings:
            print(f"{len(findings)} finding(s) in "
                  f"{len({f.path for f in findings})} file(s) "
                  f"[{len(REGISTRY)} rules]", file=sys.stderr)
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
