"""Plain DeepSeek-V2-Lite HFL training: the reference the MoE cells are judged by.

DeepSeek-V2 (arXiv:2405.04434; the published ``modeling_deepseek.py`` of
DeepSeek-V2-Lite), on the layers and experts one card holds:

* RMSNorm (scale), pre-norm residual blocks;
* MLA without a query LoRA: q = x·W_q split into q_nope (dn) and q_rope
  (dr); [c_kv, k_rope] = x·W_dkv; k_nope, v = RMSNorm(c_kv)·W_uk,
  RMSNorm(c_kv)·W_uv; RoPE on q_rope and on the k_rope all heads share;
  causal softmax over [q_nope, q_rope]·[k_nope, k_rope] at the scale
  (dn + dr)^-1/2 · mscale(factor, mscale_all_dim)²; then W_o.  Attention
  runs in query blocks, each checkpointed, so that it fits at 4,096
  positions;
* YaRN's frequencies (``DeepseekV2YarnRotaryEmbedding``): θ^(-2i/dr)
  ramped towards itself over the factor between the correction range's
  ends, cos and sin times mscale(factor, mscale) / mscale(factor,
  mscale_all_dim);
* the first ``first_k_dense`` blocks a dense SwiGLU of ``d_ff``; the others
  an MoE layer: router logits x·W_r over all E experts, softmax, greedy
  top-K (lower index first among ties), the gates the chosen probabilities
  (renormalised only where ``norm_topk_prob``), y = Σ over the chosen held
  experts (``experts_offset`` .. + ``experts_held``) of gate·SwiGLU_e(x)
  + the shared experts' SwiGLU, with no capacity and nothing dropped;
* the per-sequence balance loss Σ_e (count_e·E / (T·K))·mean_t p_e,
  averaged over the sequences, summed over the MoE layers, times
  ``router_aux_loss_coef``, added to the mean next-token cross-entropy over
  an untied head.

Departures from the published model, shared with the port: RoPE rotates
the two halves of the rope dims where the checkpoint rotates interleaved
pairs (a fixed permutation of W_q's and W_dkv's rope columns, which seeded
random weights do not see), the loss's value includes the balance loss
(the published code adds only its gradient), and what the experts held on
other cards would add is left out.  Every product runs in float32 with
TF32 off on float32 copies (``mm`` from ``reference.lm``: ``mm_fp8`` for
the control).  The HFL round is ``reference.lm``'s.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from hflbench.reference.lm import PRODUCTS, _sync, _unflatten, mm_f32, named_leaves

Q_BLOCK = 1024  # query rows a checkpointed attention block takes


def _rms(x, scale, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def yarn_range(dim, theta, beta_fast, beta_slow, original):
    """The correction range (low, high) of the published
    ``yarn_find_correction_range``."""
    corr = lambda rot: dim * math.log(original / (rot * 2 * math.pi)) / (2 * math.log(theta))
    return max(math.floor(corr(beta_fast)), 0), min(math.ceil(corr(beta_slow)), dim - 1)


def _mscale(factor, m):
    return 1.0 if factor <= 1 else 0.1 * m * math.log(factor) + 1.0


def rope_tables(T, m, device):
    """(cos, sin) [T, dr/2] of YaRN, as the published module computes them in
    float32."""
    dim, theta, factor = m["qk_rope_head_dim"], m["rope_theta"], m["yarn_factor"]
    exps = torch.arange(0, dim, 2, dtype=torch.float32) / dim
    extra = 1.0 / theta ** exps
    inter = 1.0 / (factor * theta ** exps)
    low, high = yarn_range(dim, theta, m["yarn_beta_fast"], m["yarn_beta_slow"],
                           m["yarn_original_max_pos"])
    ramp = ((torch.arange(dim // 2, dtype=torch.float32) - low)
            / (high - low if high > low else 0.001)).clamp(0, 1)
    inv = inter * ramp + extra * (1 - ramp)
    ang = torch.arange(T, dtype=torch.float32)[:, None] * inv[None, :]
    ms = _mscale(factor, m["yarn_mscale"]) / _mscale(factor, m["yarn_mscale_all_dim"])
    return (torch.cos(ang) * ms).to(device), (torch.sin(ang) * ms).to(device)


def softmax_scale(m):
    scale = (m["qk_nope_head_dim"] + m["qk_rope_head_dim"]) ** -0.5
    if m["yarn_mscale_all_dim"]:
        scale *= _mscale(m["yarn_factor"], m["yarn_mscale_all_dim"]) ** 2
    return scale


def _rotate(x, cos, sin):
    """x [B, T, heads, dr]: the two halves rotated (the port's layout)."""
    h = x.shape[-1] // 2
    x1, x2 = x[..., :h], x[..., h:]
    c, s = cos[:, None, :], sin[:, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def _attend(q, k, v, t0, scale, mm):
    """One query block: q [B, H, tq, Dk] at positions t0.., k [B, H, S, Dk],
    v [B, H, S, Dv] -> [B, H, tq, Dv]."""
    tq, S = q.shape[2], k.shape[2]
    s = mm(q, k.transpose(-1, -2)) * scale
    qpos = torch.arange(t0, t0 + tq, device=q.device)
    masked = qpos[:, None] < torch.arange(S, device=q.device)[None, :]
    p = torch.softmax(s.masked_fill(masked, float("-inf")), dim=-1)
    return mm(p, v)


def mla(x, a, cos, sin, m, mm):
    B, T, _ = x.shape
    H, r = m["num_heads"], m["kv_lora_rank"]
    dn, dr, dv = m["qk_nope_head_dim"], m["qk_rope_head_dim"], m["v_head_dim"]
    q = mm(x, a["w_q"]).view(B, T, H, dn + dr)
    q = torch.cat([q[..., :dn], _rotate(q[..., dn:], cos, sin)], dim=-1).transpose(1, 2)
    ckv = mm(x, a["w_dkv"])
    c = _rms(ckv[..., :r], a["kv_norm"]["scale"], m["norm_eps"])
    k_rope = _rotate(ckv[..., None, r:], cos, sin).expand(B, T, H, dr)
    k_nope = mm(c, a["w_uk"].reshape(r, H * dn)).view(B, T, H, dn)
    k = torch.cat([k_nope, k_rope], dim=-1).transpose(1, 2)
    v = mm(c, a["w_uv"].reshape(r, H * dv)).view(B, T, H, dv).transpose(1, 2)
    scale = softmax_scale(m)
    out = torch.cat([checkpoint(_attend, q[:, :, t0:t0 + Q_BLOCK], k, v, t0, scale, mm,
                                use_reentrant=False)
                     for t0 in range(0, T, Q_BLOCK)], dim=2)
    return mm(out.transpose(1, 2).reshape(B, T, H * dv), a["wo"])


def swiglu(x, f, mm):
    return mm(F.silu(mm(x, f["w_gate"])) * mm(x, f["w_up"]), f["w_down"])


def route(x2, router, m):
    """x2 [N, d] -> (probs [N, E], gates [N, K], expert ids [N, K])."""
    probs = torch.softmax(x2 @ router, dim=-1)  # the router's product is f32 in the program too
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, top = vals[:, :m["experts_per_token"]], ids[:, :m["experts_per_token"]]
    if m["norm_topk_prob"]:
        gates = gates / gates.sum(-1, keepdim=True)
    return probs, gates, top


def moe(x, f, m, mm):
    """The MoE layer on the held experts -> (y, the per-sequence balance loss)."""
    B, T, d = x.shape
    E, K = m["num_experts"], m["experts_per_token"]
    x2 = x.reshape(B * T, d)
    probs, gates, top = route(x2, f["router"], m)
    y = torch.zeros_like(x2)
    for j in range(m["experts_held"]):
        hit = top == m["experts_offset"] + j  # [N, K]: at most one slot a token
        tok = hit.any(-1).nonzero()[:, 0]
        if tok.numel():
            g = (gates * hit).sum(-1)[tok]
            e = {k: f[k][j] for k in ("w_gate", "w_up", "w_down")}
            y = y.index_add(0, tok, g[:, None] * swiglu(x2[tok], e, mm))
    y = y.view(B, T, d) + swiglu(x, f["shared"], mm)
    count = torch.zeros(B, E, device=x.device).scatter_add_(
        1, top.reshape(B, T * K), torch.ones(B, T * K, device=x.device))
    aux = (count * E / (T * K) * probs.view(B, T, E).mean(1)).sum(1).mean()
    return y, aux


def _block(x, p, cos, sin, m, mm):
    eps = m["norm_eps"]
    x = x + mla(_rms(x, p["norm1"]["scale"], eps), p["attn"], cos, sin, m, mm)
    h = _rms(x, p["norm2"]["scale"], eps)
    if "router" in p["ffn"]:
        y, aux = moe(h, p["ffn"], m, mm)
    else:
        y, aux = swiglu(h, p["ffn"], mm), torch.zeros((), device=x.device)
    return x + y, aux


def moe_loss(p, tokens, m, mm=mm_f32):
    """Mean next-token cross-entropy of tokens [B, T] plus the balance loss,
    under params ``p`` (a tree of f32 tensors in the port's layout)."""
    T = tokens.shape[1]
    cos, sin = rope_tables(T, m, tokens.device)
    x = p["embed"][tokens]
    aux = torch.zeros((), device=x.device)
    stacks = [("dense_blocks", m["first_k_dense"]),
              ("blocks", m["num_layers"] - m["first_k_dense"])]
    for stack, n in stacks:
        for i in range(n):
            layer = {k: _index(v, i) for k, v in p[stack].items()}
            x, a = checkpoint(_block, x, layer, cos, sin, m, mm, use_reentrant=False)
            aux = aux + a
    x = _rms(x, p["final_norm"]["scale"], m["norm_eps"])
    logits = mm(x, p["lm_head"][:, :m["vocab_size"]])[:, :-1]
    lse = torch.logsumexp(logits, dim=-1)
    tgt = logits.gather(-1, tokens[:, 1:, None])[..., 0]
    return (lse - tgt).mean() + m["router_aux_loss_coef"] * aux


def _index(tree, i):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def hfl_readings(w0, batches, m, hfl, steps, *, precision="f32", rule="hist"):
    """``reference.lm.hfl_readings`` for this model: the first ``steps``
    steps of the HFL run from ``w0`` on ``batches[s][n]``, and the flat sparse
    consensus every H steps (``reference.lm._sync``) -> ``loss``, ``grad1``,
    ``change``, as there."""
    mm = PRODUCTS[precision]
    names, w0l = zip(*named_leaves(w0))
    N, H = hfl["clusters"], hfl["period"]
    lr, mu = hfl["lr"], hfl["momentum"]
    sizes = [t.numel() for t in w0l]
    params = [[t.clone() for t in w0l] for _ in range(N)]
    mom = [[torch.zeros(t.shape, dtype=torch.float32, device=t.device) for t in w0l]
           for _ in range(N)]
    w_ref = torch.cat([t.reshape(-1).float() for t in w0l])
    eps = e = None
    losses, grad1 = [], {}
    for s in range(steps):
        row = []
        for n in range(N):
            leaf = [t.detach().float().requires_grad_(True) for t in params[n]]
            with torch.enable_grad():
                loss = moe_loss(_unflatten(names, leaf), batches[s][n], m, mm)
                grads = torch.autograd.grad(loss, leaf, allow_unused=True)
            row.append(float(loss.detach()))
            with torch.no_grad():
                for i, g in enumerate(grads):
                    if g is not None:
                        mom[n][i].mul_(mu).add_(g)
                    else:
                        mom[n][i].mul_(mu)
                    params[n][i] = (params[n][i].float() - lr * mom[n][i]).to(w0l[i].dtype)
                if s == 0:
                    for name, t in zip(names, mom[n]):
                        grad1.setdefault(name, []).append(float(torch.linalg.vector_norm(t)))
            del leaf, grads, loss
        losses.append(row)
        if (s + 1) % H == 0:
            if eps is None:
                eps = torch.zeros((N, w_ref.numel()), device=w_ref.device)
                e = torch.zeros_like(w_ref)
            _sync(params, w_ref, eps, e, hfl, rule, sizes)
    change = {}
    for n in range(N):
        for name, p, w in zip(names, params[n], w0l):
            change.setdefault(name, []).append(
                float(torch.linalg.vector_norm(p.float() - w.float())))
    for name, part, w in zip(names, w_ref.split(sizes), w0l):
        change["w_ref/" + name] = [float(torch.linalg.vector_norm(part - w.reshape(-1).float()))]
    return {"loss": losses, "grad1": grad1, "change": change}
