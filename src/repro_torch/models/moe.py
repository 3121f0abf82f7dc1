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

``cfg.dropless`` selects the port's own layer (``held_moe_forward``, no
counterpart in the reference): DeepSeek-V2's routing without capacity,
computed for the experts this layer holds (``experts_held`` from
``experts_offset``), as one chip of an expert-parallel layer computes its
part of the result. Its products run grouped over the held experts on
offsets that stay on the device (``torch._grouped_mm`` for bf16 on the
card; a loop over the experts elsewhere).
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

from repro_torch.device import resolve
from repro_torch.models.common import act_fn, dense_init, torch_dtype
from repro_torch.models.mlp import init_mlp, mlp_forward
from repro_torch.obs.metrics import current_registry
from repro_torch.obs.spans import span


def init_moe(gen, cfg, lead=(), device=None):
    device = resolve(device)
    d, E, f = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    Eh = cfg.experts_held or E  # the router spans all E, the weights the held
    dt = torch_dtype(cfg.dtype)
    lead = tuple(lead)
    p = {
        "router": dense_init(gen, lead + (d, E), torch.float32, 0.02, device),
        "w_gate": dense_init(gen, lead + (Eh, d, f), dt, 1.0 / math.sqrt(d), device),
        "w_up": dense_init(gen, lead + (Eh, d, f), dt, 1.0 / math.sqrt(d), device),
        "w_down": dense_init(gen, lead + (Eh, f, d), dt, 1.0 / math.sqrt(f), device),
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
    [E, C] (its gate, renormalized over the top-K where
    ``cfg.norm_topk_prob``)."""
    T = x.shape[0]
    E, K = cfg.num_experts, cfg.experts_per_token
    C = _capacity(cfg, T)
    probs = torch.softmax(x.float() @ router, dim=-1)
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, expert_ids = vals[:, :K], ids[:, :K]
    if cfg.norm_topk_prob:
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
    groups routed apart, each with its own capacity (``cfg.dropless``:
    ``held_moe_forward``, which has neither)."""
    if cfg.dropless:
        return held_moe_forward(p, x, cfg)
    B, T, d = x.shape
    xf = x.reshape(groups, (B * T) // groups, d)
    outs = [_route_group(xf[g], p, cfg) for g in range(groups)]
    y = torch.stack([o[0] for o in outs]).reshape(B, T, d)
    if cfg.num_shared_experts:
        y = y + mlp_forward(p["shared"], x, cfg)
    return y, torch.stack([o[1] for o in outs]).mean()


# ---------------------------------------------------------------------------
# Dropless routing over the held experts (DeepSeek-V2)
# ---------------------------------------------------------------------------

ALIGN = 16  # each held expert's rows start at a multiple of this in the grouped buffers

_load_tally = None  # the open ``tally_load``'s dict, None outside one


@contextlib.contextmanager
def tally_load():
    """``with tally_load() as load:`` sums each held expert's slot count over
    the dropless layer's calls inside (remat's recompute included) into
    ``load``: {held experts: [held] int64 tensor on the device}. Reading it
    is the caller's one device->host read."""
    global _load_tally
    prev, _load_tally = _load_tally, {}
    try:
        yield _load_tally
    finally:
        _load_tally = prev


def held_slot_rows(expert_ids, cfg):
    """Where each slot of the top-K lands in the grouped buffers. expert_ids
    [T, K] -> (rows [T·K]: the slot's row, or R for a slot whose expert is
    held elsewhere; held [T·K] bool; ends [held] int32: each held expert's
    end of rows, its rows padded to ``ALIGN``; counts [held]; R: the
    buffers' static worst case, whose row R stays empty). The slots of one
    expert keep their token order; nothing is read back to the host."""
    T, K = expert_ids.shape
    Eh, off = cfg.experts_held or cfg.num_experts, cfg.experts_offset
    dev = expert_ids.device
    local = expert_ids.reshape(-1) - off
    held = (local >= 0) & (local < Eh)
    key = torch.where(held, local, Eh)
    order = torch.argsort(key, stable=True)
    sorted_key = key[order]
    experts = torch.arange(Eh + 1, device=dev)
    bounds = torch.searchsorted(sorted_key, experts)  # [Eh + 1] first slot of each
    counts = bounds[1:] - bounds[:-1]
    padded = (counts + ALIGN - 1) // ALIGN * ALIGN
    ends = torch.cumsum(padded, 0)
    R = T * min(K, Eh) + Eh * (ALIGN - 1)
    e = sorted_key.clamp_max(Eh - 1)
    row_sorted = torch.where(sorted_key < Eh, (ends - padded)[e]
                             + torch.arange(T * K, device=dev) - bounds[e], R)
    rows = torch.empty_like(row_sorted).scatter_(0, order, row_sorted)
    return rows, held, ends.to(torch.int32), counts, R


def _grouped_route(a) -> bool:
    """bf16 on the card (or meta tensors) goes to ``torch._grouped_mm``;
    everything else to the loop over the experts."""
    return a.dtype == torch.bfloat16 and a.device.type in ("cuda", "meta")


def _gmm(a, b, ends):
    """Rows of group g of a [R, k] (rows ends[g-1]..ends[g]) times b[g] [k, n]
    -> [R, n]; rows past ends[-1] undefined (zero in the loop)."""
    if _grouped_route(a):
        return torch._grouped_mm(a, b, offs=ends)
    out = a.new_zeros(a.shape[0], b.shape[-1])
    lo = 0
    for g, hi in enumerate(ends.tolist()):
        if hi > lo:
            out[lo:hi] = a[lo:hi] @ b[g]
        lo = hi
    return out


def _gmm_w(at, b, ends):
    """Per group g: at[:, group g] [k, rows] times b[group g] [rows, n] ->
    [G, k, n] (a weight's gradient)."""
    if _grouped_route(b):
        return torch._grouped_mm(at, b, offs=ends)
    out = b.new_zeros(len(ends), at.shape[0], b.shape[-1])
    lo = 0
    for g, hi in enumerate(ends.tolist()):
        if hi > lo:
            out[g] = at[:, lo:hi] @ b[lo:hi]
        lo = hi
    return out


class HeldExperts(torch.autograd.Function):
    """The held experts' SwiGLU for every slot routed to them: x [T, d]
    gathered into the grouped rows, gate and up, SiLU(gate)·up, down, read
    back per slot -> [T·K, d] (zero for a slot held elsewhere). Forward
    (``moe.experts``) and backward (``moe.experts.backward``) are grouped
    products on the device offsets ``ends``; the backward takes SwiGLU's
    derivative in f32, and a token's gradient sums its K slots in f32."""

    @staticmethod
    def forward(ctx, x, w_gate, w_up, w_down, rows, held, ends, R):
        with span("moe.experts"):
            T, d = x.shape
            K = rows.numel() // T
            row_tok = torch.full((R + 1,), T, dtype=torch.long, device=x.device)
            row_tok.scatter_(0, rows, torch.arange(T * K, device=x.device) // K)
            row_tok[R:].fill_(T)  # slots held elsewhere all land on row R: it stays empty
            xs = torch.cat([x, x.new_zeros(1, d)])[row_tok]
            g, u = _gmm(xs, w_gate, ends), _gmm(xs, w_up, ends)
            ys = _gmm(F.silu(g) * u, w_down, ends)
            out = torch.where(held[:, None], ys[rows], 0.0)
        ctx.save_for_backward(xs, g, u, w_gate, w_up, w_down, rows, held, ends)
        ctx.K = K
        return out

    @staticmethod
    def backward(ctx, dout):
        xs, g, u, w_gate, w_up, w_down, rows, held, ends = ctx.saved_tensors
        with span("moe.experts.backward"):
            dys = torch.zeros((xs.shape[0], dout.shape[1]), dtype=dout.dtype,
                              device=dout.device)
            dys[rows] = torch.where(held[:, None], dout, 0.0)
            dys[-1:].zero_()
            gf, uf = g.float(), u.float()
            sig = torch.sigmoid(gf)
            silu = gf * sig
            h = (silu * uf).to(g.dtype)
            dh = _gmm(dys, w_down.transpose(-2, -1), ends).float()
            dw_down = _gmm_w(h.t(), dys, ends)
            dg = (dh * uf * sig * (1.0 + gf * (1.0 - sig))).to(g.dtype)
            du = (dh * silu).to(u.dtype)
            dxs = (_gmm(dg, w_gate.transpose(-2, -1), ends).float()
                   + _gmm(du, w_up.transpose(-2, -1), ends).float())
            dw_gate, dw_up = _gmm_w(xs.t(), dg, ends), _gmm_w(xs.t(), du, ends)
            dx = torch.where(held[:, None], dxs[rows], 0.0).view(
                -1, ctx.K, xs.shape[1]).sum(1)
        return (dx.to(xs.dtype), dw_gate, dw_up, dw_down, None, None, None, None)


def held_moe_forward(p, x, cfg):
    """DeepSeek-V2's MoE layer on the experts held here. x [B, T, d] ->
    (y, aux). Router logits x·W_r over all E experts in f32, softmax, top-K
    (lower index first among ties), gates the chosen probabilities
    (renormalised only where ``cfg.norm_topk_prob``); y = Σ over the chosen
    held experts of gate·SwiGLU_e(x) + the shared experts' SwiGLU, with no
    capacity and nothing dropped (an expert held elsewhere adds nothing
    here). aux: Σ_e (count_e·E / (T·K))·mean_t p_e per sequence, averaged
    over the B sequences."""
    if cfg.act != "silu" or not cfg.gated_mlp:
        raise ValueError("held_moe_forward: SwiGLU experts (act silu, gated)")
    B, T, d = x.shape
    E, K = cfg.num_experts, cfg.experts_per_token
    xf = x.reshape(B * T, d)
    with span("moe.route"):
        probs = torch.softmax(xf.float() @ p["router"], dim=-1)
        vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
        gates, expert_ids = vals[:, :K], ids[:, :K]
        if cfg.norm_topk_prob:
            gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
        rows, held, ends, counts, R = held_slot_rows(expert_ids, cfg)
        if _load_tally is not None:
            t = _load_tally.setdefault(counts.numel(), torch.zeros_like(counts))
            t += counts
    current_registry().counter("moe.routed_calls").inc(
        route="grouped" if _grouped_route(x) else "plain")
    ys = HeldExperts.apply(xf, p["w_gate"], p["w_up"], p["w_down"], rows, held, ends, R)
    with span("moe.combine"):
        g = torch.where(held.view(-1, K), gates, 0.0)
        y = (ys.view(B * T, K, d).float() * g[..., None]).sum(1).to(x.dtype).view(B, T, d)
    if cfg.num_shared_experts:
        with span("moe.shared"):
            y = y + mlp_forward(p["shared"], x, cfg)
    ce = torch.zeros(B, E, device=x.device).scatter_add_(
        1, expert_ids.reshape(B, T * K), torch.ones(B, T * K, device=x.device)) / (T * K / E)
    return y, (ce * probs.view(B, T, E).mean(1)).sum(1).mean()
