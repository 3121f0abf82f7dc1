"""GQA attention with RoPE (the dense-path part of ``repro.models.attention``).

The reference computes causal attention with a chunked online softmax in
plain jnp (no Pallas kernel), all softmax math in f32. The port computes
the same function directly: f32 scores, causal (optionally sliding-window)
mask, f32 softmax, output cast back to the input dtype. MLA and the decode
cache wait for ROADMAP Queue 1 item 15.
"""
from __future__ import annotations

import math

import torch

from repro_torch.device import resolve
from repro_torch.models.common import (
    apply_rope, default_scale, dense_init, rope_angles, torch_dtype,
)

NEG_INF = -1e30


def causal_attention(q, k, v, *, window=0):
    """q [B,T,H,D]; k,v [B,S,Hkv,D] (S == T) -> [B,T,H,D]."""
    B, T, H, D = q.shape
    G = H // k.shape[2]
    qf = q.float().transpose(1, 2)  # [B,H,T,D]
    kf = k.float().repeat_interleave(G, dim=2).transpose(1, 2)
    vf = v.float().repeat_interleave(G, dim=2).transpose(1, 2)
    s = (qf @ kf.transpose(-1, -2)) * (1.0 / math.sqrt(D))
    pos = torch.arange(T, device=q.device)
    mask = pos[:, None] >= pos[None, :]
    if window:
        mask &= pos[None, :] > (pos[:, None] - window)
    s = s.masked_fill(~mask, NEG_INF)
    out = torch.softmax(s, dim=-1) @ vf  # [B,H,T,D]
    return out.transpose(1, 2).to(q.dtype)


def init_gqa(gen, cfg, lead=(), device=None):
    device = resolve(device)
    d, H, Hkv, D = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    dt = torch_dtype(cfg.dtype)
    lead = tuple(lead)
    return {
        "wq": dense_init(gen, lead + (d, H * D), dt, default_scale(d), device),
        "wk": dense_init(gen, lead + (d, Hkv * D), dt, default_scale(d), device),
        "wv": dense_init(gen, lead + (d, Hkv * D), dt, default_scale(d), device),
        "wo": dense_init(gen, lead + (H * D, d), dt, 1.0 / math.sqrt(H * D), device),
    }


def gqa_forward(p, x, cfg, *, window=None):
    """Full-sequence (train) GQA. x [B,T,d] -> [B,T,d]."""
    B, T, _ = x.shape
    H, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q = (x @ p["wq"]).reshape(B, T, H, D)
    k = (x @ p["wk"]).reshape(B, T, Hkv, D)
    v = (x @ p["wv"]).reshape(B, T, Hkv, D)
    cos, sin = rope_angles(torch.arange(T, device=x.device), D, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    w = cfg.sliding_window if window is None else window
    out = causal_attention(q, k, v, window=w)
    return out.reshape(B, T, H * D) @ p["wo"]
