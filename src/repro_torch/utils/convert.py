"""Carrying weights and HFL state across from the JAX package, via numpy.

The reference's trees arrive as nested dicts of numpy arrays (bf16 as the
2-byte ``bfloat16`` numpy dtype, read through a 16-bit view, so this
module needs no bf16 numpy package). ``params_from_numpy`` gives the
port's params, ``state_from_numpy`` a whole ``HFLState`` whose w_ref, eps
and e are flat-backed like ``hfl_init``'s.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.hfl import HFLState
from repro_torch.device import resolve
from repro_torch.utils import flatten as fl
from repro_torch.utils.tree import tree_leaves, tree_map


def tensor_from_numpy(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(
            np.ascontiguousarray(a).view(np.int16).copy()
        ).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def params_from_numpy(tree, device="cuda"):
    dev = resolve(device)
    return tree_map(lambda a: tensor_from_numpy(a, dev), tree)


def _flat_backed(tree, rows):
    dtype = tree_leaves(tree)[0].dtype
    if rows is None:
        flat, spec = fl.pack(tree, dtype=dtype)
        return fl.unpack(flat, spec)
    flat, spec = fl.pack_stacked(tree, dtype=dtype)
    return fl.unpack_stacked(flat, spec)


def state_from_numpy(state, device="cuda") -> HFLState:
    """``state``: the reference HFLState (or a mapping with its fields) as
    numpy trees -> the port's HFLState on ``device``."""
    s = state._asdict() if hasattr(state, "_asdict") else dict(state)
    dev = resolve(device)
    conv = lambda t: params_from_numpy(t, dev)
    params = conv(s["params"])
    N = tree_leaves(params)[0].shape[0]
    opt = {k: (conv(v) if isinstance(v, dict) else int(np.asarray(v).reshape(-1)[0]))
           for k, v in s["opt"].items()}
    return HFLState(
        params=params,
        opt=opt,
        w_ref=_flat_backed(conv(s["w_ref"]), None),
        eps=_flat_backed(conv(s["eps"]), N),
        e=_flat_backed(conv(s["e"]), None),
        step=int(np.asarray(s["step"])),
    )
