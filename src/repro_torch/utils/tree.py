"""Nested-dict pytrees, flattened in ``jax.tree.flatten``'s order.

The reference's parameter trees are nested dicts, which jax flattens
depth-first with each dict's keys SORTED. The port keeps the same dicts
and the same leaf order, so flat index ``i`` names the same entry in both
packages. A tree definition is the tuple of leaf key paths.
``flatten_to_vector``/``unflatten_from_vector`` are the flat f32 vector of
``repro.utils.tree`` that the paper-exact engine trains; ``tree_add``,
``tree_scale``, ``tree_zeros_like``, ``global_norm``, ``param_count`` and
``param_bytes`` are its helpers.

``jax_leaves`` and ``jax_map`` walk the other trees jax flattens: dicts
(sorted keys), lists, tuples and NamedTuples (an ``HFLState``) are nodes,
``None`` is an empty node, and anything else is a leaf, a subclass of
tuple that is not a NamedTuple (``launch.sharding.PartitionSpec``)
included. The checkpoint's leaves and the dry-run's input specs come in
this order.
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


def _is_node(x) -> bool:
    return isinstance(x, (dict, list)) or type(x) is tuple or (
        isinstance(x, tuple) and hasattr(x, "_fields"))


def jax_leaves(tree) -> list:
    """The leaves of ``tree`` in ``jax.tree.leaves`` order (``None``
    dropped)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [l for k in sorted(tree) for l in jax_leaves(tree[k])]
    if _is_node(tree):
        return [l for v in tree for l in jax_leaves(v)]
    return [tree]


def jax_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure), called in ``jax_leaves`` order;
    -> a tree of ``tree``'s structure, ``None`` kept."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        vals = {k: jax_map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
        return {k: vals[k] for k in tree}
    if _is_node(tree):
        vals = [jax_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
        return type(tree)(*vals) if hasattr(tree, "_fields") else type(tree)(vals)
    return fn(tree, *rest)


def tree_add(a, b):
    return tree_map(torch.add, a, b)


def tree_scale(a, s):
    return tree_map(lambda x: x * s, a)


def tree_zeros_like(a):
    return tree_map(torch.zeros_like, a)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's f32 sum of squares (the
    reference's order: one reduction per leaf, then a running sum)."""
    total = sum(torch.sum(torch.square(x.float())) for x in tree_leaves(tree))
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


def param_count(tree) -> int:
    return int(sum(np.prod(x.shape) for x in tree_leaves(tree)))


def param_bytes(tree) -> int:
    return int(sum(np.prod(x.shape) * x.dtype.itemsize for x in tree_leaves(tree)))


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
