"""File walking and rule execution for the port's static analyzer."""
from __future__ import annotations

import ast
import os
from functools import cached_property
from typing import Iterable, Optional

from repro_torch.analysis import astutil as au
from repro_torch.analysis.findings import Finding, Report, parse_suppressions
from repro_torch.analysis.registry import Rule, select_rules

#: directories never scanned by default — benchmarks/examples/tests are
#: full of intentionally "bad" snippets (fixtures, throwaway sync code)
EXCLUDE_DIRS = {"benchmarks", "examples", "tests", "fixtures",
                "__pycache__", ".git", ".venv", "build", "dist",
                "node_modules"}


class FileContext:
    """Everything a rule needs about one file, computed lazily and shared
    across the rule pack."""

    def __init__(self, path: str, source: str, tree: ast.Module):
        self.path = path
        self.source = source
        self.tree = tree

    @cached_property
    def parents(self) -> dict:
        return au.build_parents(self.tree)

    @cached_property
    def functions(self) -> dict:
        return au.module_functions(self.tree)

    def under(self, *parts: str) -> bool:
        """Whether the file's path ends with ``parts`` (a directory's
        files: end with ``"*"``), separators normalised."""
        got = self.path.replace("\\", "/").split("/")
        want = list(parts)
        if want[-1] == "*":
            return len(got) > len(want) - 1 and \
                got[-len(want):-1] == want[:-1]
        return got[-len(want):] == want


def iter_python_files(paths: Iterable[str],
                      exclude_dirs: Optional[set] = None) -> Iterable[str]:
    exclude = EXCLUDE_DIRS if exclude_dirs is None else exclude_dirs
    seen = set()
    for p in paths:
        if os.path.isfile(p):
            if p not in seen:
                seen.add(p)
                yield p
            continue
        for root, dirs, files in os.walk(p):
            dirs[:] = sorted(d for d in dirs if d not in exclude)
            for f in sorted(files):
                if f.endswith(".py"):
                    fp = os.path.join(root, f)
                    if fp not in seen:
                        seen.add(fp)
                        yield fp


def analyze_source(source: str, path: str = "<string>",
                   rules: Optional[list[Rule]] = None) -> list[Finding]:
    """Run the rule packs over one source string; suppressions applied.
    Returns ALL findings (suppressed ones carry ``suppressed=True``)."""
    tree = ast.parse(source, filename=path)
    ctx = FileContext(path, source, tree)
    sups = parse_suppressions(source)
    out: list[Finding] = []
    for r in (rules if rules is not None else select_rules()):
        for f in r.check(ctx) or ():
            if not f.hint:
                f.hint = r.hint
            # a noqa on any physical line of the flagged span applies
            span = range(f.line, (f.end_line or f.line) + 1)
            for ln in span:
                sup = sups.get(ln)
                if sup is not None and sup.covers(f.rule):
                    f.suppressed = True
                    f.justification = sup.justification
                    break
            out.append(f)
    out.sort(key=lambda f: (f.line, f.col, f.rule))
    return out


def analyze_paths(paths: Iterable[str],
                  select: Optional[Iterable[str]] = None,
                  ignore: Optional[Iterable[str]] = None,
                  exclude_dirs: Optional[set] = None) -> Report:
    rules = select_rules(select, ignore)
    report = Report()
    for path in iter_python_files(paths, exclude_dirs):
        try:
            with open(path, "r", encoding="utf-8") as fh:
                source = fh.read()
        except OSError as e:
            report.parse_errors.append((path, str(e)))
            continue
        report.files_scanned += 1
        try:
            findings = analyze_source(source, path, rules)
        except SyntaxError as e:
            report.parse_errors.append((path, f"syntax error: {e}"))
            continue
        for f in findings:
            (report.suppressed if f.suppressed
             else report.findings).append(f)
    return report
