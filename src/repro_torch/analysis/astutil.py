"""Shared AST helpers for the port's rule packs.

Purely syntactic: the analyzer never imports the code it inspects.  The
name and structure helpers are the reference's (``repro/analysis/
astutil.py``), so the PIPE rules read code as its rules do; the scope and
loop helpers serve the eager-PyTorch rules.  The reference's jit- and
Pallas-site finders have no use here: the port jits nothing and writes its
kernels in CUDA C++.
"""
from __future__ import annotations

import ast
from typing import Iterator, Optional

FUNCTION_TYPES = (ast.FunctionDef, ast.AsyncFunctionDef)
SCOPE_TYPES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
LOOP_TYPES = (ast.For, ast.AsyncFor, ast.While)


# ---------------------------------------------------------------------------
# names / structure (as the reference's)
# ---------------------------------------------------------------------------

def dotted(node: ast.AST) -> Optional[str]:
    """'a.b.c' for Name/Attribute chains, else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def callee(node: ast.Call) -> Optional[str]:
    return dotted(node.func)


def callee_is(node: ast.Call, *names: str) -> bool:
    """True when the call's dotted callee matches or ends with any name
    (``build.library`` matches both ``build.library`` and
    ``kernels.build.library``)."""
    c = callee(node)
    if c is None:
        return False
    return any(c == n or c.endswith("." + n) for n in names)


def build_parents(root: ast.AST) -> dict[ast.AST, ast.AST]:
    parents: dict[ast.AST, ast.AST] = {}
    for node in ast.walk(root):
        for child in ast.iter_child_nodes(node):
            parents[child] = node
    return parents


def enclosing(node: ast.AST, parents: dict, *types) -> Optional[ast.AST]:
    """Nearest ancestor of one of the given AST types (excludes node)."""
    cur = parents.get(node)
    while cur is not None:
        if isinstance(cur, types):
            return cur
        cur = parents.get(cur)
    return None


def iter_functions(tree: ast.AST) -> Iterator[ast.FunctionDef]:
    for node in ast.walk(tree):
        if isinstance(node, FUNCTION_TYPES):
            yield node


def module_functions(tree: ast.AST) -> dict[str, ast.FunctionDef]:
    """All function defs anywhere in the module, keyed by name (last one
    wins on collision)."""
    return {fn.name: fn for fn in iter_functions(tree)}


def const_int(node: ast.AST) -> Optional[int]:
    if isinstance(node, ast.Constant) and isinstance(node.value, int) \
            and not isinstance(node.value, bool):
        return node.value
    return None


def int_tuple(node: ast.AST) -> Optional[tuple[int, ...]]:
    if (v := const_int(node)) is not None:
        return (v,)
    if isinstance(node, (ast.Tuple, ast.List)):
        out = []
        for e in node.elts:
            v = const_int(e)
            if v is None:
                return None
            out.append(v)
        return tuple(out)
    return None


def kwarg(call: ast.Call, name: str) -> Optional[ast.AST]:
    for kw in call.keywords:
        if kw.arg == name:
            return kw.value
    return None


def assign_targets(stmt: ast.stmt) -> list[ast.AST]:
    if isinstance(stmt, ast.Assign):
        out = []
        for t in stmt.targets:
            out.extend(t.elts if isinstance(t, (ast.Tuple, ast.List)) else [t])
        return out
    if isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
        return [stmt.target]
    return []


def local_env(fn: ast.FunctionDef) -> dict[str, ast.AST]:
    """name -> last RHS expression for simple single-target assignments in
    the function body (lexical order; nested defs skipped)."""
    env: dict[str, ast.AST] = {}

    def walk(body):
        for stmt in body:
            if isinstance(stmt, (*FUNCTION_TYPES, ast.ClassDef)):
                continue
            if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                    and isinstance(stmt.targets[0], ast.Name):
                env[stmt.targets[0].id] = stmt.value
            for attr in ("body", "orelse", "finalbody"):
                walk(getattr(stmt, attr, []) or [])
    walk(fn.body)
    return env


def resolve_name(node: ast.AST, env: dict[str, ast.AST],
                 depth: int = 4) -> ast.AST:
    """Chase Name -> env assignment a few hops (cycle-safe)."""
    seen = set()
    while isinstance(node, ast.Name) and node.id in env \
            and node.id not in seen and depth > 0:
        seen.add(node.id)
        node = env[node.id]
        depth -= 1
    return node


# ---------------------------------------------------------------------------
# scopes, statements and loops
# ---------------------------------------------------------------------------

def own_statements(body: list) -> Iterator[ast.stmt]:
    """Statements of a block in lexical order, into compound statements
    but not into nested function or class definitions."""
    for stmt in body:
        if isinstance(stmt, (*FUNCTION_TYPES, ast.ClassDef)):
            continue
        yield stmt
        for attr in ("body", "orelse", "finalbody"):
            yield from own_statements(getattr(stmt, attr, []) or [])
        for h in getattr(stmt, "handlers", []) or []:
            yield from own_statements(h.body)


def stmt_exprs(stmt: ast.stmt) -> Iterator[ast.AST]:
    """Every expression node of ``stmt`` itself (its test, value, targets),
    not of the statements nested in its body."""
    for child in ast.iter_child_nodes(stmt):
        if isinstance(child, ast.expr):
            yield from ast.walk(child)


def scope_of(node: ast.AST, parents: dict) -> Optional[ast.AST]:
    """The function or lambda ``node`` runs in (None: module level)."""
    return enclosing(node, parents, *SCOPE_TYPES)


def loop_in_scope(node: ast.AST, parents: dict) -> Optional[ast.AST]:
    """The innermost loop around ``node`` in ``node``'s own scope (a loop
    around the def of the function it runs in does not count)."""
    loop = enclosing(node, parents, *LOOP_TYPES)
    if loop is None or scope_of(loop, parents) is not scope_of(node,
                                                              parents):
        return None
    return loop


def is_cached(fn: Optional[ast.AST]) -> bool:
    """A def decorated with ``functools.lru_cache`` / ``cache`` (or a
    ``*_cache`` decorator): it builds once per key."""
    if not isinstance(fn, FUNCTION_TYPES):
        return False
    return any((dotted(d.func if isinstance(d, ast.Call) else d) or "")
               .endswith(("lru_cache", "cache")) for d in fn.decorator_list)


def target_names(t: ast.AST) -> Iterator[str]:
    """The names an assignment target rebinds: for an attribute or
    subscript target only the attribute or base, never the object it
    hangs off."""
    if isinstance(t, ast.Name):
        yield t.id
    elif isinstance(t, ast.Attribute):
        yield t.attr
    elif isinstance(t, (ast.Subscript, ast.Starred)):
        yield from target_names(t.value)
    elif isinstance(t, (ast.Tuple, ast.List)):
        for e in t.elts:
            yield from target_names(e)


def loop_assigned_names(loop: ast.AST) -> set:
    """Every name the loop (re)binds: its targets, assignments, walrus and
    comprehension targets anywhere inside it."""
    out = set()
    for node in ast.walk(loop):
        if isinstance(node, ast.stmt):
            for t in assign_targets(node):
                out.update(target_names(t))
        if isinstance(node, (ast.For, ast.AsyncFor, ast.comprehension)):
            out.update(target_names(node.target))
        if isinstance(node, ast.NamedExpr):
            out.update(target_names(node.target))
    return out


def names_read(node: ast.AST) -> set:
    """Names and attribute names an expression reads."""
    out = set()
    for sub in ast.walk(node):
        if isinstance(sub, ast.Name):
            out.add(sub.id)
        elif isinstance(sub, ast.Attribute):
            out.add(sub.attr)
    return out


def class_bases(tree: ast.AST) -> dict[str, list[str]]:
    """class name -> the dotted names of its bases, for every class of the
    module."""
    return {c.name: [dotted(b) or "" for b in c.bases]
            for c in ast.walk(tree) if isinstance(c, ast.ClassDef)}
