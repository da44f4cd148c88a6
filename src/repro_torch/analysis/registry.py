"""Rule registry for the port's static analyzer.

Rules are plain functions ``check(ctx) -> Iterable[Finding]`` registered
with the :func:`rule` decorator under a stable id.  Ids are grouped by
hazard class, each numbered after the reference rule it stands for
(``repro/analysis``) where one exists:

* ``CUDA1xx`` — eager PyTorch on CUDA (host syncs, builds in loops,
  re-uploads, control flow that differs between ranks): the JIT1xx rules'
  counterparts
* ``KER2xx`` — kernel contracts (the ctypes signatures against the CUDA
  prototypes, gradients that a launch would drop): the PAL2xx rules'
* ``PIPE3xx`` — pipeline invariants, the reference's rules as they are

The registry is import-driven: asking it for rules loads the three rule
packs, which register themselves here.  Adding a rule means writing one
checker function and a bad/good fixture pair in
``tests/test_torch_analysis.py`` (the tests iterate this registry, so a
rule without fixtures fails).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Iterable, Optional


@dataclass(frozen=True)
class Rule:
    id: str
    name: str                   # short kebab-case label
    summary: str                # one-line description (--list-rules)
    check: Callable             # check(ctx) -> Iterable[Finding]
    hint: str = ""              # default fix hint attached to findings


_RULES: dict[str, Rule] = {}


def rule(id: str, name: str, summary: str, hint: str = ""):
    """Register ``check(ctx)`` under a stable rule id."""
    def deco(fn):
        if id in _RULES:
            raise ValueError(f"duplicate rule id {id!r}")
        _RULES[id] = Rule(id=id, name=name, summary=summary, check=fn,
                          hint=hint)
        return fn
    return deco


def all_rules() -> list[Rule]:
    _load_packs()
    return [_RULES[k] for k in sorted(_RULES)]


def get_rule(rule_id: str) -> Optional[Rule]:
    _load_packs()
    return _RULES.get(rule_id)


def select_rules(select: Optional[Iterable[str]] = None,
                 ignore: Optional[Iterable[str]] = None) -> list[Rule]:
    """Filter the registry: ``select`` keeps only the named ids, then
    ``ignore`` drops ids (both accept ids or kebab names)."""
    rules = all_rules()
    if select:
        keys = {s.strip() for s in select}
        rules = [r for r in rules if r.id in keys or r.name in keys]
    if ignore:
        keys = {s.strip() for s in ignore}
        rules = [r for r in rules if r.id not in keys and r.name not in keys]
    return rules


_loaded = False


def _load_packs() -> None:
    global _loaded
    if _loaded:
        return
    _loaded = True
    # import for registration side effects
    from repro_torch.analysis import (kernel_rules,  # noqa: F401
                                      pipeline_rules, torch_rules)
