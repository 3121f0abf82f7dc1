"""Nested-dict pytrees, flattened in ``jax.tree.flatten``'s order.

The reference's parameter trees are nested dicts, which jax flattens
depth-first with each dict's keys SORTED. The port keeps the same dicts
and the same leaf order, so flat index ``i`` names the same entry in both
packages. A tree definition is the tuple of leaf key paths.
``flatten_to_vector``/``unflatten_from_vector`` are the flat f32 vector of
``repro.utils.tree`` that the paper-exact engine trains.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

import numpy as np
import torch

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


def flatten_to_vector(tree):
    """All leaves, in leaf order, concatenated into one flat f32 vector,
    plus the static aux that ``unflatten_from_vector`` needs."""
    leaves, treedef = tree_flatten(tree)
    shapes = [tuple(l.shape) for l in leaves]
    dtypes = [l.dtype for l in leaves]
    sizes = [int(np.prod(s)) for s in shapes]
    vec = (torch.cat([l.reshape(-1).float() for l in leaves]) if leaves
           else torch.zeros((0,), dtype=torch.float32))
    return vec, (treedef, shapes, dtypes, sizes)


def unflatten_from_vector(vec, aux):
    """The tree back from a flat vector. Leaves of the vector's own dtype
    are VIEWS of it, so autograd through them yields one flat gradient;
    one ``split`` makes them, whose backward is one concatenation (a slice
    per leaf would build a full-size gradient per leaf)."""
    treedef, shapes, dtypes, sizes = aux
    return tree_unflatten(treedef, [
        part.reshape(shape).to(dtype)
        for part, shape, dtype in zip(vec.split(sizes), shapes, dtypes)])
