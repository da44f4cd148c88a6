"""Pipeline-invariant rules (PIPE3xx), as ``repro/analysis/pipeline_rules.py``.

The port keeps the names these rules read (``balanced_boundaries``,
``pattern_boundary``, ``merge_paged_with_mask``, ``CacheSnapshot``), so
they apply to it as they are: the same ids, semantics and findings.

FlexPipe's refactoring correctness rests on three structural invariants
that are easy to get wrong in code and invisible to pytest until a
specific fault/refactor interleaving hits them:

* PIPE301 — stage boundaries ``[0, b1, ..]`` turn into ``(lo, hi)`` ranges
  via the zip-shift idiom; forgetting the ``n_layers`` terminator silently
  drops the last stage.  Boundary *choosers* must also consult the graph's
  constraint groups (``pattern_boundary``) so a cut never splits a
  mixer/MoE block pair.
* PIPE302 — block-allocator lifecycle: every path that retires a slot
  (completion, preemption, retry) must free its blocks, and every
  ``alloc`` must handle pool exhaustion (``None``).
* PIPE303 — Eq. 10 threading: paged snapshot merges must be driven by a
  ``block_validity`` mask computed from SNAPSHOT-time tables, and every
  ``CacheSnapshot`` must carry a real ``valid_len``.
"""
from __future__ import annotations

import ast
from typing import Iterable

from repro_torch.analysis import astutil as au
from repro_torch.analysis.findings import Finding
from repro_torch.analysis.registry import rule

_RANGE_NAMES = {"lo", "hi", "start", "end", "begin", "stop"}


# ---------------------------------------------------------------------------
# PIPE301 — stage-range construction
# ---------------------------------------------------------------------------

def _is_bare_shift(node: ast.AST, first_src: str, env: dict) -> bool:
    """True when ``node`` is exactly ``<first>[1:]`` (no terminator)."""
    node = au.resolve_name(node, env)
    if not isinstance(node, ast.Subscript):
        return False
    sl = node.slice
    if not (isinstance(sl, ast.Slice) and au.const_int(sl.lower) == 1
            and sl.upper is None and sl.step is None):
        return False
    try:
        return ast.unparse(node.value) == first_src
    except Exception:               # pragma: no cover
        return False


def _boundaryish(call: ast.Call, parents: dict) -> bool:
    """Is this zip consumed as stage ranges?  Either the first argument
    names boundaries, or the loop target / assigned name is range-ish."""
    try:
        if "bound" in ast.unparse(call.args[0]).lower():
            return True
    except Exception:               # pragma: no cover
        pass
    loop = au.enclosing(call, parents, ast.For)
    if loop is not None and isinstance(loop.target, ast.Tuple) \
            and len(loop.target.elts) == 2:
        names = {t.id for t in loop.target.elts
                 if isinstance(t, ast.Name)}
        if names and names <= _RANGE_NAMES:
            return True
    stmt = au.enclosing(call, parents, ast.Assign)
    if stmt is not None:
        for t in au.assign_targets(stmt):
            if isinstance(t, ast.Name) \
                    and any(k in t.id.lower()
                            for k in ("range", "bound", "seg")):
                return True
    return False


@rule("PIPE301", "stage-range-shift",
      "stage ranges built by zip(bounds, bounds[1:]) without the n_layers "
      "terminator, or a malformed literal boundary list",
      hint="append the terminator: zip(bounds, bounds[1:] + [n_layers]) — "
           "the bare shift yields len-1 ranges and drops the final stage")
def check_stage_range_shift(ctx) -> Iterable[Finding]:
    parents = ctx.parents
    for fn in au.iter_functions(ctx.tree):
        env = au.local_env(fn)
        for node in ast.walk(fn):
            if not (isinstance(node, ast.Call)
                    and au.callee(node) == "zip" and len(node.args) == 2):
                continue
            try:
                first_src = ast.unparse(node.args[0])
            except Exception:       # pragma: no cover
                continue
            if not _boundaryish(node, parents):
                continue
            if _is_bare_shift(node.args[1], first_src, env):
                yield Finding(
                    rule="PIPE301", path=ctx.path, line=node.lineno,
                    col=node.col_offset, end_line=node.end_lineno,
                    message=f"`zip({first_src}, {first_src}[1:])` drops "
                            f"the final stage: the shifted list has no "
                            f"layer-count terminator")
    # literal boundary lists must start at layer 0 and be strictly
    # increasing (ranges via zip-shift assume both)
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Assign):
            continue
        try:
            tgt_src = " ".join(ast.unparse(t)
                               for t in au.assign_targets(node))
        except Exception:           # pragma: no cover
            continue
        if "boundar" not in tgt_src.lower():
            continue
        vals = au.int_tuple(node.value)
        if vals is None:
            continue
        if vals[0] != 0 or any(nxt <= prev
                               for nxt, prev in zip(vals[1:], vals[:-1])):
            yield Finding(
                rule="PIPE301", path=ctx.path, line=node.lineno,
                col=node.col_offset, end_line=node.end_lineno,
                message=f"boundary list {list(vals)} must start at 0 and "
                        f"be strictly increasing (stage s owns layers "
                        f"[b[s], b[s+1]))")


@rule("PIPE301C", "partition-constraint-groups",
      "a stage-boundary chooser ignores the graph's constraint groups",
      hint="consult OpNode.pattern_boundary (core/graph.py) when scoring "
           "cuts — a boundary inside a mixer/MoE constraint group splits "
           "state that must stay on one stage")
def check_partition_constraints(ctx) -> Iterable[Finding]:
    for fn in au.iter_functions(ctx.tree):
        if not (fn.name == "partition" or fn.name.startswith("partition_")
                or fn.name.startswith("choose_boundar")):
            continue
        refs = {n.attr for n in ast.walk(fn)
                if isinstance(n, ast.Attribute)}
        refs |= {n.id for n in ast.walk(fn) if isinstance(n, ast.Name)}
        if not any("pattern_boundary" in r or "constraint_group" in r
                   for r in refs):
            yield Finding(
                rule="PIPE301C", path=ctx.path, line=fn.lineno,
                col=fn.col_offset,
                message=f"boundary chooser `{fn.name}` never reads "
                        f"pattern_boundary/constraint groups: it can cut "
                        f"inside a constraint group")


# ---------------------------------------------------------------------------
# PIPE302 — allocator lifecycle
# ---------------------------------------------------------------------------

_FREEING = ("free", "_free_slot_blocks", "_preempt_slot", "release")


def _module_uses_allocator(tree: ast.AST) -> bool:
    for node in ast.walk(tree):
        if isinstance(node, (ast.Attribute, ast.Name)):
            nm = node.attr if isinstance(node, ast.Attribute) else node.id
            if "allocator" in nm.lower():
                return True
    return False


@rule("PIPE302", "allocator-leak",
      "a slot-retirement or block-allocation path that can leak pool "
      "blocks",
      hint="pair every `.done = True` with a block free in the same "
           "method, and None-check every allocator.alloc() (pool "
           "exhaustion returns None)")
def check_allocator_leak(ctx) -> Iterable[Finding]:
    if not _module_uses_allocator(ctx.tree):
        return
    for fn in au.iter_functions(ctx.tree):
        frees = any(
            isinstance(n, ast.Call)
            and (au.callee(n) or "").split(".")[-1] in _FREEING
            for n in ast.walk(fn))
        for node in ast.walk(fn):
            # <slot>.done = True  ==> blocks must be freed on this path
            if isinstance(node, ast.Assign) \
                    and isinstance(node.value, ast.Constant) \
                    and node.value.value is True:
                for t in node.targets:
                    if isinstance(t, ast.Attribute) and t.attr == "done" \
                            and not frees:
                        yield Finding(
                            rule="PIPE302", path=ctx.path,
                            line=node.lineno, col=node.col_offset,
                            end_line=node.end_lineno,
                            message=f"`{fn.name}` retires a slot "
                                    f"(.done = True) but never frees its "
                                    f"blocks — the pool leaks on this "
                                    f"path")
            # ids = allocator.alloc(n)  ==> must handle None
            if isinstance(node, ast.Assign) \
                    and isinstance(node.value, ast.Call) \
                    and (au.callee(node.value) or "").endswith(".alloc"):
                names = [t.id for t in au.assign_targets(node)
                         if isinstance(t, ast.Name)]
                if not names:
                    continue
                checked = False
                for sub in ast.walk(fn):
                    if isinstance(sub, ast.Compare) \
                            and isinstance(sub.left, ast.Name) \
                            and sub.left.id == names[0] \
                            and all(isinstance(op, (ast.Is, ast.IsNot))
                                    for op in sub.ops):
                        checked = True
                        break
                if not checked:
                    yield Finding(
                        rule="PIPE302", path=ctx.path, line=node.lineno,
                        col=node.col_offset, end_line=node.end_lineno,
                        message=f"allocator.alloc() result `{names[0]}` "
                                f"in `{fn.name}` is never None-checked — "
                                f"pool exhaustion returns None")


# ---------------------------------------------------------------------------
# PIPE303 — Eq. 10 snapshot/restore threading
# ---------------------------------------------------------------------------

def _references_valid(node: ast.AST) -> bool:
    try:
        src = ast.unparse(node).lower()
    except Exception:               # pragma: no cover
        return False
    return "valid" in src or "bv" == src.strip()


@rule("PIPE303", "eq10-threading",
      "an Eq. 10 snapshot/merge call site drops or mis-threads "
      "valid_len / block_validity",
      hint="merge_paged_with_mask needs the block_validity mask computed "
           "from SNAPSHOT-time tables; CacheSnapshot must carry the "
           "per-slot valid_len")
def check_eq10_threading(ctx) -> Iterable[Finding]:
    for fn in au.iter_functions(ctx.tree):
        env = au.local_env(fn)
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            tail = (au.callee(node) or "").split(".")[-1]
            if tail == "merge_paged_with_mask":
                mask = (node.args[2] if len(node.args) > 2
                        else au.kwarg(node, "block_valid"))
                resolved = au.resolve_name(mask, env) \
                    if mask is not None else None
                from_bv = isinstance(resolved, ast.Call) and \
                    (au.callee(resolved) or "").split(".")[-1] \
                    == "block_validity"
                if mask is None or not (from_bv
                                        or _references_valid(mask)):
                    yield Finding(
                        rule="PIPE303", path=ctx.path, line=node.lineno,
                        col=node.col_offset, end_line=node.end_lineno,
                        message="merge_paged_with_mask is not driven by a "
                                "block_validity mask — blocks freed and "
                                "reused since the snapshot would be "
                                "restored as if still owned")
            elif tail == "block_validity" and node.args:
                first = node.args[0]
                try:
                    src = ast.unparse(first).lower()
                except Exception:   # pragma: no cover
                    src = ""
                if "snap" not in src:
                    yield Finding(
                        rule="PIPE303", path=ctx.path, line=node.lineno,
                        col=node.col_offset, end_line=node.end_lineno,
                        message=f"block_validity walks `{src}` — Eq. 10 "
                                f"requires the SNAPSHOT-time tables (live "
                                f"tables may have freed/reassigned blocks "
                                f"since the snapshot)")
            elif tail == "CacheSnapshot":
                vl = (node.args[1] if len(node.args) > 1
                      else au.kwarg(node, "valid_len"))
                if vl is None or isinstance(vl, ast.Constant) \
                        or not _references_valid(vl):
                    yield Finding(
                        rule="PIPE303", path=ctx.path, line=node.lineno,
                        col=node.col_offset, end_line=node.end_lineno,
                        message="CacheSnapshot without a real valid_len: "
                                "restore cannot distinguish committed "
                                "rows from stale ones (Eq. 10)")
