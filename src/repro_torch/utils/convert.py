"""Carrying weights and HFL state across from the JAX package, via numpy.

The reference's trees arrive as nested dicts of numpy arrays (bf16 as the
2-byte ``bfloat16`` numpy dtype, read through a 16-bit view, so this
module needs no bf16 numpy package). ``params_from_numpy`` gives the
port's params from any such tree (transformer params, or ResNet-18
``params`` and ``bn_state``), ``state_from_numpy`` a whole ``HFLState``
whose w_ref, eps and e are flat-backed like ``hfl_init``'s, and
``faithful_state_from_numpy`` the state dict of ``FaithfulHFL``.
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
    # moment trees go to ``device``; counters (AdamW's int32 t [N]) stay
    # per cluster, as int64 on the CPU
    opt = {k: (conv(v) if isinstance(v, dict)
               else torch.from_numpy(np.asarray(v).astype(np.int64)))
           for k, v in s["opt"].items()}
    return HFLState(
        params=params,
        opt=opt,
        w_ref=_flat_backed(conv(s["w_ref"]), None),
        eps=_flat_backed(conv(s["eps"]), N),
        e=_flat_backed(conv(s["e"]), None),
        step=int(np.asarray(s["step"])),
    )


FAITHFUL_KEYS = ("w_tilde_n", "u", "v", "e_n", "eps_n", "w_ref", "e")


def faithful_state_from_numpy(state, device="cuda") -> dict:
    """The reference ``FaithfulHFL.state`` (a dict of arrays) -> the port's:
    the seven buffers as tensors on ``device`` and the step ``t`` as an
    int."""
    dev = resolve(device)
    out = {k: tensor_from_numpy(state[k], dev) for k in FAITHFUL_KEYS}
    out["t"] = int(np.asarray(state["t"]))
    return out
