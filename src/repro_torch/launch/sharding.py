"""Sharding policy: param/cache/batch leaves -> partition specs (the port of
``repro.launch.sharding``), and each rank's block of a leaf under a spec.

FSDP + TP hybrid: for every parameter leaf the largest divisible dim is
tensor-parallel over "model" and the largest remaining divisible dim is
fully-sharded over "data". Leaves under a stacked-layer collection
("blocks") never shard axis 0, and "data" goes only on the first weight
dim. Cluster-replicated leaves get the leading "pod" axis prepended by the
HFL engine (``with_leading``), never here. The specs are pure functions of
shapes and equal the reference's ``PartitionSpec`` entry for entry.

Beyond the reference, ``rank_block`` cuts the block of a leaf that one
mesh coordinate holds, in jax's block order (axis index times block size;
several axes on one dim are data-major, the first axis the slowest), and
``place_block`` writes such a block back into the whole leaf: the rank-local
state of the mesh syncs is made and put back together with these.

``to_shardings`` and ``shaped`` build the dry-run's inputs, the
counterparts of jax's ``NamedSharding`` and ``ShapeDtypeStruct``: each
leaf's global shape, dtype and spec, and the block one rank holds, by the
same rule as ``rank_block``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.launch import mesh as _mesh
from repro_torch.utils.tree import jax_map, tree_flatten, tree_map, tree_unflatten


class PartitionSpec(tuple):
    """A partition spec: one entry per leading dim of a leaf, each None
    (replicated), a mesh axis name, or a tuple of names."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return "P" + tuple.__repr__(tuple(self))


P = PartitionSpec


def leaf_spec(shape, *, data: int, model: int, skip_axes=(), data_dims=None) -> P:
    """Greedy assignment: "model" (TP) on the largest divisible dim; "data"
    (FSDP) restricted to ``data_dims`` (default: any dim)."""
    dims = [i for i in range(len(shape)) if i not in skip_axes]
    order = sorted(dims, key=lambda i: -shape[i])
    assign = [None] * len(shape)
    for axis_name, size in (("model", model), ("data", data)):
        if size <= 1:
            continue
        for i in order:
            if axis_name == "data" and data_dims is not None and i not in data_dims:
                continue
            if assign[i] is None and shape[i] % size == 0 and shape[i] >= size:
                assign[i] = axis_name
                break
    return P(*assign) if any(assign) else P()


def param_specs(params, *, data: int, model: int):
    """Tree of specs for a (single-cluster) param tree of tensors or
    shapes-bearing leaves: leaves under "blocks" never shard axis 0, and
    "data" goes only on the first weight dim."""
    leaves, treedef = tree_flatten(params)
    out = []
    for path, leaf in zip(treedef, leaves):
        shape = tuple(leaf.shape)
        stacked = "blocks" in path
        skip = (0,) if stacked else ()
        first = 1 if stacked else 0
        ddims = (first,) if len(shape) - len(skip) >= 2 else None
        out.append(leaf_spec(shape, data=data, model=model, skip_axes=skip,
                             data_dims=ddims))
    return tree_unflatten(treedef, out)


def with_leading(spec_tree, axis: str):
    """Prepend a mesh axis (the cluster/pod axis) to every spec."""
    return tree_map(lambda s: P(axis, *s), spec_tree)


def batch_spec(ndim: int, *, pod: bool) -> P:
    """[N, B, ...] (train, pod axis leading) or [B, ...] (serve)."""
    if pod:
        return P("pod", "data", *([None] * (ndim - 2)))
    return P("data", *([None] * (ndim - 1)))


def cache_specs(cache, *, data: int, model: int, batch_axis: int = 1):
    """KV/SSM cache: batch dim over "data" when divisible, one more big dim
    over "model"."""

    def spec(leaf):
        shape = tuple(leaf.shape)
        assign = [None] * len(shape)
        bi = batch_axis if len(shape) > batch_axis else 0
        if data > 1 and shape[bi] % data == 0 and shape[bi] >= data:
            assign[bi] = "data"
        if model > 1:
            order = sorted(range(len(shape)), key=lambda i: -shape[i])
            for i in order:
                if assign[i] is None and shape[i] % model == 0 and shape[i] >= model:
                    assign[i] = "model"
                    break
        return P(*assign) if any(assign) else P()

    return tree_map(spec, cache)


def _block_slices(shape, spec, mesh_shape: Dict[str, int], coord: Dict[str, int]):
    out = []
    for d, n in enumerate(shape):
        entry = spec[d] if d < len(spec) else None
        names = (() if entry is None else (entry,) if isinstance(entry, str)
                 else tuple(entry))
        parts = int(np.prod([mesh_shape.get(a, 1) for a in names]))
        if parts == 1:
            out.append(slice(None))
            continue
        i = 0
        for a in names:  # the first axis varies slowest
            i = i * mesh_shape.get(a, 1) + (coord.get(a, 0) if a in mesh_shape else 0)
        b = n // parts
        out.append(slice(i * b, (i + 1) * b))
    return tuple(out)


def rank_block(x, spec, mesh_shape: Dict[str, int], coord: Dict[str, int]):
    """The block of ``x`` that the rank at mesh coordinate ``coord`` holds
    under ``spec`` (a contiguous copy); ``mesh_shape``/``coord`` map axis
    names to sizes / indices."""
    return x[_block_slices(tuple(x.shape), spec, mesh_shape, coord)].contiguous()


def place_block(out, block, spec, mesh_shape: Dict[str, int], coord: Dict[str, int]):
    """Write ``block`` into the whole leaf ``out`` where ``rank_block``
    cut it from; -> out."""
    out[_block_slices(tuple(out.shape), spec, mesh_shape, coord)] = block
    return out


# ---------------------------------------------------------------------------
# Dry-run inputs: shapes with shardings, nothing allocated
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (jax's ``NamedSharding``)."""

    mesh: Any
    spec: PartitionSpec


@dataclass(frozen=True)
class ShapeDtypeStruct:
    """A leaf's global shape and dtype, and optionally its sharding (jax's
    ``ShapeDtypeStruct``); ``block_shape`` is the block one rank holds."""

    shape: Tuple[int, ...]
    dtype: torch.dtype
    sharding: Any = None

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def spec(self) -> PartitionSpec:
        return self.sharding.spec if self.sharding is not None else P()

    @property
    def block_shape(self) -> Tuple[int, ...]:
        if self.sharding is None:
            return tuple(self.shape)
        sl = _block_slices(tuple(self.shape), self.spec,
                           _mesh.mesh_shape(self.sharding.mesh), {})
        return tuple(len(range(*s.indices(n))) for s, n in zip(sl, self.shape))

    @property
    def block_nbytes(self) -> int:
        """The bytes of one rank's block."""
        return int(np.prod(self.block_shape, dtype=np.int64)) * self.dtype.itemsize


def to_shardings(spec_tree, mesh):
    """Each spec of ``spec_tree`` on ``mesh``."""
    return jax_map(lambda s: NamedSharding(mesh, s), spec_tree)


def reference_dtype(dtype) -> torch.dtype:
    """The dtype the reference's leaf has: jax runs with 64-bit types off,
    so the port's int64 leaves (token ids, cache positions, counters) are
    int32 there, and f64 is f32."""
    return {torch.int64: torch.int32, torch.float64: torch.float32}.get(dtype, dtype)


def shaped(tree_shapes, shardings):
    """``ShapeDtypeStruct``s of ``tree_shapes`` (tensors, meta ones
    included, or ``ShapeDtypeStruct``s) with ``shardings`` attached, in the
    reference's dtypes (``reference_dtype``)."""
    return jax_map(lambda l, s: ShapeDtypeStruct(tuple(l.shape), reference_dtype(l.dtype),
                                                 sharding=s), tree_shapes, shardings)
