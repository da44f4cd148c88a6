"""The port's static analyzer (eager-CUDA / kernel contract / pipeline
rules), jax-free and standard library only.

Programmatic entry points::

    from repro_torch.analysis import analyze_paths, analyze_source
    report = analyze_paths(["src/repro_torch"])

CLI: ``python -m repro_torch.analysis --help``.  The rules stand for the
reference analyzer's (``src/repro/analysis``) where the port has the
hazard, and each rule's docstring names the rule it stands for; the
suppression syntax is the same: ``# repro: noqa[RULE] -- justification``.
"""
from repro_torch.analysis.findings import (ALL_RULES, Finding, Report,
                                           Suppression, parse_suppressions)
from repro_torch.analysis.registry import (Rule, all_rules, get_rule, rule,
                                           select_rules)
from repro_torch.analysis.runner import (EXCLUDE_DIRS, FileContext,
                                         analyze_paths, analyze_source,
                                         iter_python_files)

__all__ = [
    "ALL_RULES", "EXCLUDE_DIRS", "FileContext", "Finding", "Report",
    "Rule", "Suppression", "all_rules", "analyze_paths", "analyze_source",
    "get_rule", "iter_python_files", "parse_suppressions", "rule",
    "select_rules",
]
