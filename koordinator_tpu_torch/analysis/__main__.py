"""CLI: ``python -m koordinator_tpu_torch.analysis`` (koordlint over the
port).

Exit status 0 = clean, 1 = violations (one ``file:line: [rule] message``
per line), 2 = usage error.  The same pass runs under tier-1 via
``tests/test_torch_koordlint.py``, so CI and the CLI can never disagree.
"""

from __future__ import annotations

import argparse
import sys

from koordinator_tpu_torch.analysis import RULES
from koordinator_tpu_torch.analysis.core import run_repo


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m koordinator_tpu_torch.analysis",
        description="koordlint over the PyTorch port: static rules, "
        "the lock-order graph and the wire-contract cross-check",
    )
    ap.add_argument(
        "--root",
        default=None,
        help="repo root (default: auto-detected from the package location)",
    )
    ap.add_argument(
        "--rules",
        default=None,
        help=f"comma-separated subset of rules to run (all: {','.join(RULES)})",
    )
    ap.add_argument(
        "--list-rules", action="store_true", help="print rule names and exit"
    )
    ap.add_argument(
        "--suppressions", action="store_true",
        help="audit every live 'koordlint: disable=' tag: list them "
        "with reasons; stale tags and reason-required rules suppressed "
        "without a reason fail the run",
    )
    ap.add_argument(
        "--write-lockorder", action="store_true",
        help="regenerate koordinator_tpu_torch/analysis/LOCKORDER.md "
        "from the derived lock graph and exit",
    )
    args = ap.parse_args(argv)
    if args.list_rules:
        for rule in RULES:
            print(rule)
        return 0
    if args.write_lockorder:
        from koordinator_tpu_torch.analysis import lockgraph
        from koordinator_tpu_torch.analysis.core import find_repo_root

        path = lockgraph.write_lockorder(args.root or find_repo_root())
        print(f"wrote {path}")
        return 0
    if args.suppressions:
        from koordinator_tpu_torch.analysis import suppressions

        tags, problems = suppressions.audit(args.root)
        print(suppressions.format_report(tags, problems))
        return 1 if problems else 0
    rules = None
    if args.rules:
        rules = [r.strip() for r in args.rules.split(",") if r.strip()]
        unknown = [r for r in rules if r not in RULES]
        if unknown:
            print(f"unknown rule(s): {', '.join(unknown)}", file=sys.stderr)
            return 2
    # root=None lets run_repo resolve the repo from the package location,
    # so the CLI works from any cwd
    violations = run_repo(root=args.root, rules=rules)
    for v in violations:
        print(v.format())
    if violations:
        print(
            f"koordlint: {len(violations)} violation(s)  "
            "(suppress a line with '# koordlint: disable=<rule>')",
            file=sys.stderr,
        )
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
