"""Findings and suppression comments for the port's static analyzer.

The same syntax and semantics as ``repro/analysis/findings.py``, so one
comment means the same thing to both analyzers.

A :class:`Finding` is one file:line diagnostic with a stable rule id, a
human message, and a fix hint.  Suppression is per-line via

    # repro: noqa[RULE_ID]            -- optional justification
    # repro: noqa[RULE_A,RULE_B]      (several rules)
    # repro: noqa                     (blanket: every rule on this line)

The justification after ``--`` is captured and carried on the suppressed
finding so reports (and reviewers) can audit WHY a hazard is accepted.
A noqa on any physical line spanned by the flagged statement applies, so
multi-line calls can carry the comment on whichever line reads best; a
noqa on a standalone comment line also covers the next code line, so long
statements can carry the comment just above instead of at end-of-line.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Optional

NOQA_RE = re.compile(
    r"#\s*repro:\s*noqa"
    r"(?:\[(?P<rules>[A-Za-z0-9_,\s-]+)\])?"
    r"(?:\s*--\s*(?P<why>.*\S))?")

#: sentinel rule set meaning "suppress everything on this line"
ALL_RULES = "*"


@dataclass(frozen=True)
class Suppression:
    line: int
    rules: frozenset            # rule ids, or frozenset({ALL_RULES})
    justification: str = ""

    def covers(self, rule_id: str) -> bool:
        return ALL_RULES in self.rules or rule_id in self.rules


def parse_suppressions(source: str) -> dict[int, Suppression]:
    """Map 1-based line number -> Suppression for every noqa comment.

    A noqa on a comment-only line also registers for the next code line
    (skipping further comment/blank lines), so it can sit just above the
    statement it suppresses."""
    out: dict[int, Suppression] = {}
    lines = source.splitlines()
    for i, line in enumerate(lines, start=1):
        m = NOQA_RE.search(line)
        if not m:
            continue
        raw = m.group("rules")
        rules = (frozenset(r.strip() for r in raw.split(",") if r.strip())
                 if raw else frozenset({ALL_RULES}))
        sup = Suppression(i, rules, (m.group("why") or "").strip())
        out[i] = sup
        if line.strip().startswith("#"):
            j = i
            while j < len(lines) and (not lines[j].strip()
                                      or lines[j].strip().startswith("#")):
                j += 1
            if j < len(lines):
                out.setdefault(j + 1, sup)
    return out


@dataclass
class Finding:
    rule: str                   # stable id, e.g. "JIT102"
    path: str                   # file path as given to the runner
    line: int
    col: int
    message: str
    hint: str = ""              # how to fix (or how to suppress legitimately)
    end_line: Optional[int] = None
    suppressed: bool = False
    justification: str = ""     # from the suppressing noqa comment

    def location(self) -> str:
        return f"{self.path}:{self.line}:{self.col + 1}"

    def to_dict(self) -> dict:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "col": self.col, "message": self.message, "hint": self.hint,
                "suppressed": self.suppressed,
                "justification": self.justification}

    def format_text(self) -> str:
        tag = " (suppressed"
        tag += f": {self.justification})" if self.justification else ")"
        head = f"{self.location()}: {self.rule} {self.message}"
        if self.suppressed:
            head += tag
        if self.hint and not self.suppressed:
            head += f"\n    hint: {self.hint}"
        return head


@dataclass
class Report:
    """Aggregate result of one analyzer run."""
    findings: list = field(default_factory=list)       # unsuppressed
    suppressed: list = field(default_factory=list)     # suppressed findings
    files_scanned: int = 0
    parse_errors: list = field(default_factory=list)   # (path, message)

    def counts_by_rule(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for f in self.findings:
            out[f.rule] = out.get(f.rule, 0) + 1
        return dict(sorted(out.items()))

    def to_dict(self) -> dict:
        return {
            "files_scanned": self.files_scanned,
            "n_findings": len(self.findings),
            "n_suppressed": len(self.suppressed),
            "counts_by_rule": self.counts_by_rule(),
            "findings": [f.to_dict() for f in self.findings],
            "suppressed": [f.to_dict() for f in self.suppressed],
            "parse_errors": [{"path": p, "message": m}
                             for p, m in self.parse_errors],
        }
