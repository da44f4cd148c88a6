"""Nested dicts, lists, tuples and NamedTuples of tensors ("trees").

Leaves come in the order in which ``jax.tree_util`` flattens the same
nesting: dict keys sorted, lists and tuples in order, NamedTuple fields in
order, ``None`` holding no leaf.  So a tree of the port and the same tree of
the JAX package list their leaves alike, which the checkpoint format and
the optimizer's sums rely on.
"""
from __future__ import annotations

from typing import Any, Callable


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_flatten(tree) -> tuple[list, Any]:
    """(leaves, treedef); ``tree_unflatten(treedef, leaves)`` rebuilds it."""
    leaves: list = []

    def walk(t):
        if t is None:
            return ("none",)
        if isinstance(t, dict):
            keys = sorted(t)
            return ("dict", keys, [walk(t[k]) for k in keys])
        if _is_namedtuple(t):
            return ("namedtuple", type(t), [walk(x) for x in t])
        if isinstance(t, (list, tuple)):
            return (type(t).__name__, None, [walk(x) for x in t])
        leaves.append(t)
        return ("leaf",)

    treedef = walk(tree)
    return leaves, treedef


def tree_unflatten(treedef, leaves):
    it = iter(leaves)

    def build(d):
        kind = d[0]
        if kind == "none":
            return None
        if kind == "leaf":
            return next(it)
        children = [build(c) for c in d[2]]
        if kind == "dict":
            return dict(zip(d[1], children))
        if kind == "namedtuple":
            return d[1](*children)
        return list(children) if kind == "list" else tuple(children)

    out = build(treedef)
    if next(it, None) is not None:
        raise ValueError("tree_unflatten: more leaves than the tree holds")
    return out


def tree_leaves(tree) -> list:
    return tree_flatten(tree)[0]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and of each tree in ``rest``
    (same structure), into a tree of ``tree``'s structure."""
    leaves, treedef = tree_flatten(tree)
    others = [tree_flatten(r)[0] for r in rest]
    return tree_unflatten(treedef, [fn(*xs) for xs in zip(leaves, *others)])
