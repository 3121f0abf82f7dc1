"""Plain olmo-style HFL training: the reference the LM cells are judged by.

An olmo-style decoder (arXiv:2402.00838): non-parametric LayerNorm, RoPE
on the two halves of each head, causal softmax attention, SwiGLU, a head
tied to the embedding, cross-entropy over next tokens.  Parameters are
stored in the configuration's dtype; every product runs in float32 with
TF32 off (``mm_f32``) on a float32 copy, so the reference computes the
configuration above its own precision.  ``mm_fp8`` rounds both operands of
every product to float8 e4m3 with one scale a tensor: the control.

The HFL round (Alg. 5 with the sparse flat consensus): each cluster takes
momentum-SGD steps on its own rows, the update rounded to the parameters'
dtype; every H steps each cluster's drift (w_n - w_ref) + β_s·ε_n goes up
through Ω(φ_up), the MBS forms δ = Σ sent_n / N + β_m·e, sends Ω(δ, φ_down)
down, and every cluster adopts the new reference.  The flat vector is the
leaves in sorted-key order, depth first.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from hflbench.reference.omega import sparse_hop


def named_leaves(tree, prefix=""):
    """[(path, tensor)] depth first, each dict's keys sorted."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in named_leaves(tree[k], prefix + k + "/")]
    return [(prefix[:-1], tree)]


def mm_f32(a, b):
    return a @ b


def fp8_round(t):
    """t rounded to float8 e4m3 under one scale (its max over 448), in f32;
    the gradient passes through the rounding unchanged."""
    scale = t.detach().abs().amax().clamp_min(1e-30) / 448.0
    q = (t.detach() / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    return t + (q - t).detach()


def mm_fp8(a, b):
    return fp8_round(a) @ fp8_round(b)


PRODUCTS = {"f32": mm_f32, "fp8": mm_fp8}


def _ln(x, eps):
    c = x - x.mean(-1, keepdim=True)
    return c / torch.sqrt((c * c).mean(-1, keepdim=True) + eps)


def _rope(T, D, theta, device):
    inv = (1.0 / theta ** (torch.arange(0, D, 2, dtype=torch.float64) / D)).float()
    ang = torch.arange(T, dtype=torch.float32)[:, None] * inv[None, :]
    return torch.cos(ang).to(device), torch.sin(ang).to(device)


def _rotate(x, cos, sin):
    h = x.shape[-1] // 2
    x1, x2 = x[..., :h], x[..., h:]
    c, s = cos[:, None, :], sin[:, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def _layer(x, wq, wk, wv, wo, wg, wu, wd, cos, sin, m, mm):
    B, T, _ = x.shape
    H, Hkv, D = m["num_heads"], m["num_kv_heads"], m["head_dim"]
    h = _ln(x, m["norm_eps"])
    q = _rotate(mm(h, wq).view(B, T, H, D), cos, sin).transpose(1, 2)
    k = _rotate(mm(h, wk).view(B, T, Hkv, D), cos, sin).transpose(1, 2)
    v = mm(h, wv).view(B, T, Hkv, D).transpose(1, 2)
    if Hkv != H:  # query head j reads kv head j // (H / Hkv)
        k = k.repeat_interleave(H // Hkv, dim=1)
        v = v.repeat_interleave(H // Hkv, dim=1)
    s = mm(q, k.transpose(-1, -2)) * (1.0 / math.sqrt(D))
    causal = torch.ones(T, T, dtype=torch.bool, device=x.device).triu(1)
    p = torch.softmax(s.masked_fill(causal, float("-inf")), dim=-1)
    o = mm(p, v).transpose(1, 2).reshape(B, T, H * D)
    x = x + mm(o, wo)
    h = _ln(x, m["norm_eps"])
    return x + mm(F.silu(mm(h, wg)) * mm(h, wu), wd)


def lm_loss(p, tokens, m, mm=mm_f32):
    """Mean next-token cross-entropy of tokens [B, T] under params ``p``
    (a tree of f32 tensors in the port's layout)."""
    T = tokens.shape[1]
    cos, sin = _rope(T, m["head_dim"], m["rope_theta"], tokens.device)
    x = p["embed"][tokens]
    a, f = p["blocks"]["attn"], p["blocks"]["ffn"]
    for i in range(m["num_layers"]):
        x = checkpoint(_layer, x, a["wq"][i], a["wk"][i], a["wv"][i], a["wo"][i],
                       f["w_gate"][i], f["w_up"][i], f["w_down"][i], cos, sin, m, mm,
                       use_reentrant=False)
    x = _ln(x, m["norm_eps"])
    logits = mm(x, p["embed"][:m["vocab_size"]].t())[:, :-1]
    lse = torch.logsumexp(logits, dim=-1)
    tgt = logits.gather(-1, tokens[:, 1:, None])[..., 0]
    return (lse - tgt).mean()


def _unflatten(names, tensors):
    out: dict = {}
    for name, t in zip(names, tensors):
        d = out
        parts = name.split("/")
        for k in parts[:-1]:
            d = d.setdefault(k, {})
        d[parts[-1]] = t
    return out


def _norms(ts):
    return [float(torch.linalg.vector_norm(t.float())) for t in ts]


def hfl_readings(w0, batches, m, hfl, steps, *, precision="f32", rule="hist"):
    """Follow the first ``steps`` steps of the HFL run from weights ``w0`` on
    ``batches[s][n]`` (cluster n's tokens at step s).  -> readings: ``loss``
    [steps][N], ``grad1`` {leaf: [N]} (the first step's gradient norms),
    ``change`` {leaf: [N], "w_ref/"+leaf: [1]} (the change of every cluster's
    parameters and of the reference after the last step followed)."""
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
            tok = batches[s][n]
            leaf = [t.detach().float().requires_grad_(True) for t in params[n]]
            with torch.enable_grad():
                loss = lm_loss(_unflatten(names, leaf), tok, m, mm)
                grads = torch.autograd.grad(loss, leaf, allow_unused=True)
            row.append(float(loss.detach()))
            with torch.no_grad():
                for i, g in enumerate(grads):
                    if g is None:
                        g = torch.zeros_like(leaf[i])
                    mom[n][i].mul_(mu).add_(g)
                    params[n][i] = (params[n][i].float() - lr * mom[n][i]).to(w0l[i].dtype)
                if s == 0:
                    for name, v in zip(names, _norms(mom[n])):
                        grad1.setdefault(name, []).append(v)
            del leaf, grads, loss
        losses.append(row)
        if (s + 1) % H == 0:
            if eps is None:
                eps = torch.zeros((N, w_ref.numel()), device=w_ref.device)
                e = torch.zeros_like(w_ref)
            _sync(params, w_ref, eps, e, hfl, rule, sizes)
    change = {}
    for n in range(N):
        for name, v in zip(names, _norms([p.float() - w for p, w in zip(params[n], w0l)])):
            change.setdefault(name, []).append(v)
    for name, part, w in zip(names, w_ref.split(sizes), w0l):
        change["w_ref/" + name] = [float(torch.linalg.vector_norm(part - w.reshape(-1).float()))]
    return {"loss": losses, "grad1": grad1, "change": change}


@torch.no_grad()
def _sync(params, w_ref, eps, e, hfl, rule, sizes):
    """The flat sparse consensus, in place: eps rows, e, w_ref and every
    cluster's parameters (which adopt w_ref in their dtype)."""
    N = len(params)
    acc = torch.zeros_like(w_ref)
    for n in range(N):
        drift = torch.cat([p.reshape(-1).float() for p in params[n]]) - w_ref
        drift += hfl["beta_s"] * eps[n]
        sent, eps[n] = sparse_hop(drift, hfl["phi"][2], rule)
        acc += sent
        del drift, sent
    delta = acc / N + hfl["beta_m"] * e
    del acc
    d, resid = sparse_hop(delta, hfl["phi"][3], rule)
    e.copy_(resid)
    w_ref += d
    del d, resid, delta
    for n in range(N):
        for i, part in enumerate(w_ref.split(sizes)):
            params[n][i] = part.reshape(params[n][i].shape).to(params[n][i].dtype)
