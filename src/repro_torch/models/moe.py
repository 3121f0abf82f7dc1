"""Capacity-based token-choice MoE with gather/scatter dispatch: the port of
``repro.models.moe``.

Tokens are routed by a sort into a dense [E, C, d] activation per group,
two batched products per expert, and a scatter-add combine. All shapes are
static; a token beyond its expert's capacity is dropped. Two orders are the
reference's and matter where probabilities tie (a zero router ties them
all): ``lax.top_k`` keeps the lower expert index first, which a stable
descending sort gives (``torch.topk`` promises no order), and
``jnp.argsort`` is stable, as ``torch.argsort(stable=True)`` is. The
combine adds each expert's output into its token's row with
``index_add_``, whose order of addition on the card is not the
reference's: a token routed to K experts sums K rows in another order.
"""
from __future__ import annotations

import math

import torch

from repro_torch.device import resolve
from repro_torch.models.common import act_fn, dense_init, torch_dtype
from repro_torch.models.mlp import init_mlp, mlp_forward


def init_moe(gen, cfg, lead=(), device=None):
    device = resolve(device)
    d, E, f = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    dt = torch_dtype(cfg.dtype)
    lead = tuple(lead)
    p = {
        "router": dense_init(gen, lead + (d, E), torch.float32, 0.02, device),
        "w_gate": dense_init(gen, lead + (E, d, f), dt, 1.0 / math.sqrt(d), device),
        "w_up": dense_init(gen, lead + (E, d, f), dt, 1.0 / math.sqrt(d), device),
        "w_down": dense_init(gen, lead + (E, f, d), dt, 1.0 / math.sqrt(f), device),
    }
    if cfg.num_shared_experts:
        p["shared"] = init_mlp(gen, cfg, lead, device,
                               d_ff=cfg.moe_d_ff * cfg.num_shared_experts)
    return p


def _capacity(cfg, tokens_per_group: int) -> int:
    c = int(math.ceil(tokens_per_group * cfg.experts_per_token
                      * cfg.capacity_factor / cfg.num_experts))
    return max(8, int(math.ceil(c / 8) * 8))


def route_tables(x, router, cfg):
    """The routing of one token group x [T, d] -> dict of the router's
    ``probs`` [T, E], the top-K ``expert_ids`` [T, K] (lower index first
    among ties), the stable ``order`` of the T·K slots by expert, each
    sorted slot's ``dest`` in the [E·C] table (E·C = the drop bin) and the
    tables ``idx`` [E, C] (token per expert slot, T = empty) and ``gts``
    [E, C] (its renormalized gate)."""
    T = x.shape[0]
    E, K = cfg.num_experts, cfg.experts_per_token
    C = _capacity(cfg, T)
    probs = torch.softmax(x.float() @ router, dim=-1)
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, expert_ids = vals[:, :K], ids[:, :K]
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)

    flat_e = expert_ids.reshape(-1)
    flat_t = torch.arange(T, device=x.device).repeat_interleave(K)
    order = torch.argsort(flat_e, stable=True)
    e_s, t_s, g_s = flat_e[order], flat_t[order], gate_vals.reshape(-1)[order]
    seg_start = torch.searchsorted(e_s, torch.arange(E, device=x.device))
    pos = torch.arange(T * K, device=x.device) - seg_start[e_s]
    dest = torch.where(pos < C, e_s * C + pos, E * C)
    # the drop bin E·C takes every dropped slot and is cut off
    idx = torch.full((E * C + 1,), T, dtype=torch.long, device=x.device)
    idx = idx.index_put((dest,), t_s)
    gts = torch.zeros(E * C + 1, device=x.device).index_put((dest,), g_s)
    return {"probs": probs, "expert_ids": expert_ids,
            "order": order, "dest": dest, "idx": idx[:-1].reshape(E, C),
            "gts": gts[:-1].reshape(E, C)}


def _route_group(x, p, cfg):
    """One token group. x [T, d] -> (y [T, d], aux_loss scalar)."""
    T, d = x.shape
    E, K = cfg.num_experts, cfg.experts_per_token
    r = route_tables(x, p["router"], cfg)
    idx, gts = r["idx"], r["gts"]

    x_pad = torch.cat([x, x.new_zeros(1, d)])  # row T = zeros
    xe = x_pad[idx]  # [E, C, d]
    h = act_fn(cfg.act)(torch.bmm(xe, p["w_gate"])) * torch.bmm(xe, p["w_up"])
    ye = torch.bmm(h, p["w_down"]) * gts[..., None].to(h.dtype)
    y = x.new_zeros(T + 1, d).index_add(0, idx.reshape(-1),
                                        ye.reshape(-1, d))[:T]

    # load-balance auxiliary loss (Switch-style)
    me = r["probs"].mean(0)
    ce = torch.zeros(E, device=x.device).index_add(
        0, r["expert_ids"].reshape(-1),
        torch.ones(T * K, device=x.device)) / (T * K)
    return y, E * (me * ce).sum()


def moe_forward(p, x, cfg, *, groups=1):
    """x [B, T, d] -> (y, aux_loss). ``groups`` partitions B·T into token
    groups routed apart, each with its own capacity."""
    B, T, d = x.shape
    xf = x.reshape(groups, (B * T) // groups, d)
    outs = [_route_group(xf[g], p, cfg) for g in range(groups)]
    y = torch.stack([o[0] for o in outs]).reshape(B, T, d)
    if cfg.num_shared_experts:
        y = y + mlp_forward(p["shared"], x, cfg)
    return y, torch.stack([o[1] for o in outs]).mean()
