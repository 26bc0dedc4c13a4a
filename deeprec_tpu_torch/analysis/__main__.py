"""CLI: ``python -m deeprec_tpu_torch.analysis [--check | --fix-baseline]``
(the port's copy of `deeprec_tpu/analysis/__main__.py`).

Exit codes: 0 = clean (every finding suppressed or baselined), 1 = new
findings or stale baseline entries, 2 = usage error.
"""
from __future__ import annotations

import argparse
import sys

from deeprec_tpu_torch.analysis import lint


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m deeprec_tpu_torch.analysis",
        description="PyTorch-aware static analysis for deeprec_tpu_torch "
                    "(rule catalog: deeprec_tpu_torch/analysis/lint.py)",
    )
    p.add_argument("targets", nargs="*", default=None,
                   help="files/dirs relative to the repo root "
                        f"(default: {', '.join(lint.DEFAULT_TARGETS)})")
    p.add_argument("--check", action="store_true",
                   help="lint and compare against the baseline (CI gate; "
                        "the default action)")
    p.add_argument("--fix-baseline", action="store_true",
                   help="rewrite the baseline to accept every current "
                        "unsuppressed finding")
    p.add_argument("--baseline", default=None,
                   help="baseline file (default: "
                        "deeprec_tpu_torch/analysis/baseline.txt)")
    p.add_argument("--root", default=None,
                   help="repo root (default: auto-detected)")
    p.add_argument("--rules", default=None,
                   help="comma list of rule codes to run (default: all)")
    p.add_argument("--list", dest="list_all", action="store_true",
                   help="print every finding (incl. suppressed/baselined) "
                        "and exit 0")
    p.add_argument("--list-rules", action="store_true",
                   help="print the rule catalog and exit")
    args = p.parse_args(argv)

    if args.list_rules:
        for code, doc in sorted(lint.RULES.items()):
            print(f"{code}  {doc}")
        return 0
    rules = (
        [r.strip().upper() for r in args.rules.split(",") if r.strip()]
        if args.rules else None
    )
    if rules:
        unknown = sorted(set(rules) - set(lint.RULES))
        if unknown:
            print(f"unknown rule(s): {', '.join(unknown)}", file=sys.stderr)
            return 2
    root = args.root or lint.repo_root()
    targets = tuple(args.targets) if args.targets else lint.DEFAULT_TARGETS

    if args.list_all:
        mods = lint.collect_modules(root, targets)
        findings = lint.run_rules(mods, rules)
        active, suppressed = lint.split_suppressed(mods, findings)
        for f in findings:
            tag = " (noqa)" if f in suppressed else ""
            print(f.render() + tag)
        print(f"{len(findings)} finding(s), {len(suppressed)} suppressed")
        return 0

    return lint.check(
        root=root, targets=targets, baseline_path=args.baseline,
        rules=rules, fix_baseline=args.fix_baseline,
    )


if __name__ == "__main__":
    sys.exit(main())
