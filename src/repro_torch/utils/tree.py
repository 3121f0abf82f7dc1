"""Nested-dict pytrees, flattened in ``jax.tree.flatten``'s order.

The reference's parameter trees are nested dicts, which jax flattens
depth-first with each dict's keys SORTED. The port keeps the same dicts
and the same leaf order, so flat index ``i`` names the same entry in both
packages. A tree definition is the tuple of leaf key paths.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

TreeDef = Tuple[Tuple[str, ...], ...]


def tree_flatten(tree) -> Tuple[List[Any], TreeDef]:
    leaves: list = []
    paths: list = []

    def rec(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                rec(node[k], path + (k,))
        else:
            leaves.append(node)
            paths.append(path)

    rec(tree, ())
    return leaves, tuple(paths)


def tree_leaves(tree) -> List[Any]:
    return tree_flatten(tree)[0]


def tree_unflatten(treedef: TreeDef, leaves):
    leaves = list(leaves)
    if treedef == ((),):
        return leaves[0]
    out: dict = {}
    for path, leaf in zip(treedef, leaves):
        d = out
        for k in path[:-1]:
            d = d.setdefault(k, {})
        d[path[-1]] = leaf
    return out


def tree_map(fn: Callable, tree, *rest):
    leaves, treedef = tree_flatten(tree)
    others = [tree_flatten(r)[0] for r in rest]
    return tree_unflatten(treedef, [fn(*xs) for xs in zip(leaves, *others)])
