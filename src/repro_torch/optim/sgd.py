"""Optimizers: momentum SGD (the paper's choice) and AdamW.

The port of ``repro.optim.sgd`` with the same API, ``opt.init(params) ->
state`` and ``opt.update(grads, state, params, lr) -> (params, state)``,
and the same arithmetic: f32 moments, weight decay only on leaves with
ndim >= 2 (the stacked [L, 1] norm placeholders count as 2-D, as in the
reference), each update cast back to the param's dtype.

``update`` works IN PLACE: the param and moment tensors are overwritten
and returned (the reference's jitted step donates them instead), so a
full-size model holds one copy of its optimizer state. SGDM's update goes
leaf by leaf, by device, to one of two routes that round alike, bit for bit
(``kernels.sgdm``): every CUDA leaf to the hand-written kernel, one pass a
leaf, which raises on a leaf it cannot take (``kernels.sgdm.takes``:
contiguous, an f32 moment, a bf16 or f32 param and grad); every other leaf
(the CPU, ``meta``) to the torch ops of ``kernels.sgdm.sgdm_plain``. Each
leaf updated counts once in
``optim.sgdm_leaves{route=kernel|plain}`` of the ambient registry. AdamW's step
counter ``t`` is an int64 CPU tensor, advanced in place too: 0-d for one
model, [N] per cluster in an ``HFLState`` (``core.hfl.hfl_init`` widens it
as the reference's vmapped ``init`` does), where each cluster's update
advances only its own entry.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.kernels.sgdm import kernel as _sgdm
from repro_torch.obs.metrics import current_registry
from repro_torch.utils.tree import tree_leaves, tree_map


@dataclass(frozen=True)
class SGDM:
    momentum: float = 0.9
    weight_decay: float = 0.0
    nesterov: bool = False

    def init(self, params):
        return {"m": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                    device=p.device), params)}

    @torch.no_grad()
    def update(self, grads, state, params, lr):
        hyper = (lr, self.momentum, self.weight_decay, self.nesterov)
        routes = {"kernel": 0, "plain": 0}
        for g, m, p in zip(tree_leaves(grads), tree_leaves(state["m"]),
                           tree_leaves(params)):
            if p.device.type == "cuda":
                _sgdm.sgdm_update(g, m, p, *hyper)
                routes["kernel"] += 1
            else:
                _sgdm.sgdm_plain(g, m, p, *hyper)
                routes["plain"] += 1
        leaves = current_registry().counter("optim.sgdm_leaves")
        for route, n in routes.items():
            if n:
                leaves.inc(n, route=route)
        return params, state


@dataclass(frozen=True)
class AdamW:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1

    def init(self, params):
        z = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return {"m": tree_map(z, params), "v": tree_map(z, params),
                "t": torch.zeros((), dtype=torch.int64)}

    @torch.no_grad()
    def update(self, grads, state, params, lr):
        state["t"] += 1  # a view of one cluster's entry advances only it
        t = int(state["t"])
        # the bias corrections in f32, as the reference's 1 - b ** f32(t)
        c1 = float(1.0 - torch.tensor(self.b1) ** t)
        c2 = float(1.0 - torch.tensor(self.b2) ** t)
        for g, m, v, p in zip(tree_leaves(grads), tree_leaves(state["m"]),
                              tree_leaves(state["v"]), tree_leaves(params)):
            g = g.float()
            m.mul_(self.b1).add_((1 - self.b1) * g)
            v.mul_(self.b2).add_((1 - self.b2) * g * g)
            step = (m / c1) / (torch.sqrt(v / c2) + self.eps)
            if self.weight_decay:
                step = step + (self.weight_decay * p.float() if p.ndim >= 2 else 0.0)
            p.copy_((p.float() - lr * step).to(p.dtype))
        return params, state
