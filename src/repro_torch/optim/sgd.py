"""Optimizers: momentum SGD (the paper's choice) and AdamW.

The port of ``repro.optim.sgd`` with the same API, ``opt.init(params) ->
state`` and ``opt.update(grads, state, params, lr) -> (params, state)``,
and the same arithmetic: f32 moments, weight decay only on leaves with
ndim >= 2 (the stacked [L, 1] norm placeholders count as 2-D, as in the
reference), each update cast back to the param's dtype.

``update`` works IN PLACE: the param and moment tensors are overwritten
and returned (the reference's jitted step donates them instead), so a
full-size model holds one copy of its optimizer state. AdamW's step
counter ``t`` is an int64 CPU tensor, advanced in place too: 0-d for one
model, [N] per cluster in an ``HFLState`` (``core.hfl.hfl_init`` widens it
as the reference's vmapped ``init`` does), where each cluster's update
advances only its own entry.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.utils.tree import tree_leaves, tree_map


def _decayed(g, p, wd):
    if not wd:
        return g
    return g + (wd * p.float() if p.ndim >= 2 else 0.0)


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
        for g, m, p in zip(tree_leaves(grads), tree_leaves(state["m"]),
                           tree_leaves(params)):
            g = _decayed(g.float(), p, self.weight_decay)
            m.mul_(self.momentum).add_(g)
            step = (g + self.momentum * m) if self.nesterov else m
            p.copy_((p.float() - lr * step).to(p.dtype))
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
