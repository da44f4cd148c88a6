"""CLI for the port's static analyzer.

    python -m repro_torch.analysis [paths...] [--format text|json]
                             [--fail-on-findings] [--report FILE]
                             [--select RULES] [--ignore RULES]
                             [--show-suppressed] [--list-rules]
                             [--include-excluded-dirs]

Default path is ``src/repro_torch`` with ``benchmarks/``/``tests/`` (and other
fixture-bearing directories) excluded, so a bare invocation is directly
usable as a pre-commit hook.  Exit code 1 iff ``--fail-on-findings`` and
unsuppressed findings (or parse errors) exist; 2 on bad usage.
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.analysis.registry import all_rules, select_rules
from repro_torch.analysis.runner import EXCLUDE_DIRS, analyze_paths

DEFAULT_PATHS = ["src/repro_torch"]


def _split(opt) -> list[str]:
    out: list[str] = []
    for chunk in opt or []:
        out.extend(s for s in chunk.split(",") if s.strip())
    return out


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="The PyTorch port's static analyzer: eager-CUDA, "
                    "kernel contract, and pipeline-invariant hazards.")
    p.add_argument("paths", nargs="*", default=None,
                   help=f"files/dirs to scan (default: {DEFAULT_PATHS})")
    p.add_argument("--format", choices=("text", "json"), default="text",
                   help="output format (default: text)")
    p.add_argument("--report", metavar="FILE",
                   help="also write the full JSON report to FILE")
    p.add_argument("--fail-on-findings", action="store_true",
                   help="exit 1 when unsuppressed findings exist")
    p.add_argument("--select", action="append", metavar="RULES",
                   help="comma-separated rule ids/names to run")
    p.add_argument("--ignore", action="append", metavar="RULES",
                   help="comma-separated rule ids/names to skip")
    p.add_argument("--show-suppressed", action="store_true",
                   help="also print suppressed findings (with their "
                        "justifications)")
    p.add_argument("--list-rules", action="store_true",
                   help="list registered rules and exit")
    p.add_argument("--include-excluded-dirs", action="store_true",
                   help=f"also scan the default-excluded dirs "
                        f"({', '.join(sorted(EXCLUDE_DIRS))})")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    if args.list_rules:
        for r in all_rules():
            print(f"{r.id:<9} {r.name:<28} {r.summary}")
        return 0

    select = _split(args.select) or None
    ignore = _split(args.ignore) or None
    if select:
        known = {r.id for r in all_rules()} | {r.name for r in all_rules()}
        bad = [s for s in select if s not in known]
        if bad:
            print(f"unknown rule(s): {', '.join(bad)}", file=sys.stderr)
            return 2

    paths = args.paths or DEFAULT_PATHS
    exclude = set() if args.include_excluded_dirs else None
    report = analyze_paths(paths, select=select, ignore=ignore,
                           exclude_dirs=exclude)

    if args.report:
        with open(args.report, "w", encoding="utf-8") as fh:
            json.dump(report.to_dict(), fh, indent=2)

    if args.format == "json":
        json.dump(report.to_dict(), sys.stdout, indent=2)
        print()
    else:
        shown = list(report.findings)
        if args.show_suppressed:
            shown += report.suppressed
            shown.sort(key=lambda f: (f.path, f.line, f.col))
        for f in shown:
            print(f.format_text())
        for path, msg in report.parse_errors:
            print(f"{path}: PARSE-ERROR {msg}")
        counts = report.counts_by_rule()
        tail = (", ".join(f"{k}: {v}" for k, v in counts.items())
                or "no findings")
        print(f"[repro_torch.analysis] {report.files_scanned} files, "
              f"{len(report.findings)} finding(s) "
              f"({len(report.suppressed)} suppressed) — {tail}")

    if args.fail_on_findings and (report.findings or report.parse_errors):
        return 1
    return 0
