"""The port's lint command line: ``python -m repro_torch.analysis
[paths...]`` (counterpart of ``repro.analysis.cli``).

Exit codes:
  0 — clean (suppressed findings allowed)
  1 — findings
  2 — the linter itself could not run (bad usage, crashed rule, unreadable
      tree): a loud failure, never a pass.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Optional, Sequence

from repro_torch.analysis.core import DEFAULT_PATHS, lint_paths, rule_table


def _build_parser() -> argparse.ArgumentParser:
    codes = ", ".join(code for code, _, _ in rule_table())
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description=f"the port's lint: AST rules {codes} over the PyTorch "
                    f"port's tree")
    p.add_argument("paths", nargs="*", default=None,
                   help=f"files/directories to lint "
                        f"(default: {' '.join(DEFAULT_PATHS)})")
    p.add_argument("--root", default=None,
                   help="repo root anchoring relative paths and the "
                        "project-level rules (default: cwd)")
    p.add_argument("--format", choices=("text", "json"), default="text",
                   help="stdout format (default: text)")
    p.add_argument("--output", default=None, metavar="FILE",
                   help="additionally write the full JSON report to FILE "
                        "(CI uploads this as an artifact)")
    p.add_argument("--select", default=None, metavar="CODES",
                   help="comma-separated rule codes to run (default: all)")
    p.add_argument("--ignore", default=None, metavar="CODES",
                   help="comma-separated rule codes to skip")
    p.add_argument("--list-rules", action="store_true",
                   help="print the rule table and exit")
    return p


def _codes(raw: Optional[str]):
    return [c.strip() for c in raw.split(",") if c.strip()] if raw else None


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = _build_parser().parse_args(argv)

    if args.list_rules:
        for code, name, summary in rule_table():
            print(f"{code}  {name:<24} {summary}")
        return 0

    paths = args.paths or list(DEFAULT_PATHS)
    try:
        report = lint_paths(paths, root=args.root,
                            select=_codes(args.select),
                            ignore=_codes(args.ignore))
    except Exception as exc:   # never die silently
        print(f"repro_torch.analysis: internal error: {type(exc).__name__}: {exc}",
              file=sys.stderr)
        return 2

    if args.output:
        with open(args.output, "w", encoding="utf-8") as fh:
            json.dump(report.to_dict(), fh, indent=2, sort_keys=True)
            fh.write("\n")

    if args.format == "json":
        print(json.dumps(report.to_dict(), indent=2, sort_keys=True))
    else:
        for f in report.findings:
            print(f"{f.location()}: {f.code} [{f.rule}] {f.message}")
        for e in report.errors:
            print(f"repro_torch.analysis: ERROR: {e}", file=sys.stderr)
        n, m = len(report.findings), len(report.suppressed)
        if report.clean and not report.errors:
            print(f"repro_torch.analysis: clean — {report.files_scanned} "
                  f"files, "
                  f"{m} suppressed finding(s)")
        else:
            print(f"repro_torch.analysis: {n} finding(s), {m} suppressed, "
                  f"{report.files_scanned} files scanned", file=sys.stderr)

    if report.errors:
        return 2
    return 0 if report.clean else 1


if __name__ == "__main__":
    sys.exit(main())
