"""Flat-buffer packing of model trees for whole-model Ω (paper §IV).

The port of ``repro.utils.flatten``: every leaf gets a static offset in
ONE contiguous vector, in jax's leaf order, so flat index ``i`` names the
same model entry in both packages. With ``shards > 1`` the vector gets a
zero tail of ``pad`` entries so it splits into ``shards`` equal
contiguous pieces (the sharded flat vector); offsets never change, so a
shard's local index plus its offset IS the whole-model index.

Beyond the reference, a tree can be *flat-backed*: its leaves are views
of one flat buffer laid out by its ``FlatSpec`` (``flat_backed_zeros``,
``unpack`` of an own-dtype vector). ``backing`` finds that buffer again,
so the sync reads and updates the HFL error/reference buffers in place
instead of packing copies of them (the reference donates its buffers to
XLA for the same memory reason).
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.utils.tree import tree_flatten, tree_unflatten


class FlatSpec(NamedTuple):
    """Static layout of a tree inside a flat vector (one row of ``[N, Q]``
    for stacked trees). ``shards``/``pad``: the padded layout, whose
    ``padded_total = total + pad`` entries split into ``shards`` pieces of
    ``local_size``; shard s holds positions ``shard_slice(s)``."""

    treedef: Any
    shapes: Tuple[Tuple[int, ...], ...]
    dtypes: Tuple[Any, ...]
    sizes: Tuple[int, ...]
    offsets: Tuple[int, ...]
    total: int  # Q
    shards: int = 1
    pad: int = 0  # zero tail entries appended for even sharding

    def leaf_slice(self, i: int) -> slice:
        return slice(self.offsets[i], self.offsets[i] + self.sizes[i])

    @property
    def padded_total(self) -> int:
        return self.total + self.pad

    @property
    def local_size(self) -> int:
        return self.padded_total // self.shards

    def shard_slice(self, s: int) -> slice:
        return slice(s * self.local_size, (s + 1) * self.local_size)


def _spec(leaves, treedef, drop_leading: int, shards: int) -> FlatSpec:
    shapes = tuple(tuple(l.shape[drop_leading:]) for l in leaves)
    dtypes = tuple(l.dtype for l in leaves)
    sizes = tuple(int(np.prod(s)) if s else 1 for s in shapes)
    offsets = tuple(int(o) for o in np.cumsum((0,) + sizes)[:-1])
    total = int(sum(sizes))
    pad = (-total) % shards if shards > 1 else 0
    return FlatSpec(treedef, shapes, dtypes, sizes, offsets, total, shards, pad)


def spec_of(tree, *, shards: int = 1) -> FlatSpec:
    leaves, treedef = tree_flatten(tree)
    return _spec(leaves, treedef, 0, shards)


def spec_of_stacked(tree, *, shards: int = 1) -> FlatSpec:
    """FlatSpec of a leading-axis-stacked tree (one row's layout)."""
    leaves, treedef = tree_flatten(tree)
    return _spec(leaves, treedef, 1, shards)


def pack(tree, *, dtype=torch.float32, shards: int = 1):
    """Tree -> (flat vector [padded_total] of ``dtype``, FlatSpec)."""
    leaves, treedef = tree_flatten(tree)
    spec = _spec(leaves, treedef, 0, shards)
    vec = torch.cat([l.reshape(-1).to(dtype) for l in leaves]
                    + [leaves[0].new_zeros((spec.pad,), dtype=dtype)])
    return vec, spec


def unpack(vec, spec: FlatSpec):
    """Flat vector [Q or padded_total] -> tree with the spec's dtypes (a
    padded tail is ignored). A leaf whose dtype is the vector's own is a
    VIEW of ``vec`` (the tree is flat-backed)."""
    leaves = [
        vec[spec.leaf_slice(i)].reshape(spec.shapes[i]).to(spec.dtypes[i])
        for i in range(len(spec.sizes))
    ]
    return tree_unflatten(spec.treedef, leaves)


def pack_stacked(tree, *, dtype=torch.float32, shards: int = 1):
    """Tree with a shared leading axis N -> ([N, padded_total] matrix,
    FlatSpec)."""
    leaves, treedef = tree_flatten(tree)
    spec = _spec(leaves, treedef, 1, shards)
    n = leaves[0].shape[0]
    mat = torch.cat([l.reshape(n, -1).to(dtype) for l in leaves]
                    + [leaves[0].new_zeros((n, spec.pad), dtype=dtype)], dim=1)
    return mat, spec


def unpack_stacked(mat, spec: FlatSpec):
    """[N, Q] matrix -> tree of [N, ...] leaves with the spec's dtypes
    (views of ``mat`` where the dtype matches)."""
    n = mat.shape[0]
    leaves = [
        mat[:, spec.leaf_slice(i)].reshape((n,) + spec.shapes[i])
        .to(spec.dtypes[i])
        for i in range(len(spec.sizes))
    ]
    return tree_unflatten(spec.treedef, leaves)


def flat_backed_zeros(spec: FlatSpec, rows: Optional[int], dtype, device):
    """(zero flat buffer [Q'] or [rows, Q'], tree of views into it), Q' the
    spec's ``padded_total``."""
    if rows is None:
        flat = torch.zeros((spec.padded_total,), dtype=dtype, device=device)
        return flat, unpack(flat, spec._replace(dtypes=(dtype,) * len(spec.sizes)))
    flat = torch.zeros((rows, spec.padded_total), dtype=dtype, device=device)
    return flat, unpack_stacked(
        flat, spec._replace(dtypes=(dtype,) * len(spec.sizes)))


def backing(tree, spec: FlatSpec, rows: Optional[int] = None):
    """The flat buffer a flat-backed tree's leaves view, or None.

    Checks that every leaf is a view of ONE contiguous ``[Q']`` (or
    ``[rows, Q']``) tensor at exactly the spec's offset and row stride, Q'
    the spec's ``padded_total``.
    """
    leaves, _ = tree_flatten(tree)
    if not leaves:
        return None
    base = leaves[0]._base
    Qp = spec.padded_total
    want = (Qp,) if rows is None else (rows, Qp)
    if (base is None or tuple(base.shape) != want
            or not base.is_contiguous()):
        return None
    b0 = base.storage_offset()
    for leaf, off, shape in zip(leaves, spec.offsets, spec.shapes):
        if leaf._base is not base or leaf.dtype != base.dtype:
            return None
        if leaf.storage_offset() != b0 + off:
            return None
        inner = torch.empty(shape, device="meta").stride()
        stride = inner if rows is None else (Qp,) + tuple(inner)
        full = shape if rows is None else (rows,) + tuple(shape)
        if tuple(leaf.shape) != tuple(full):
            return None
        # strides of size-1 dims are arbitrary; the rest must be row-major
        if any(n > 1 and s != w
               for n, s, w in zip(full, leaf.stride(), stride)):
            return None
    return base
