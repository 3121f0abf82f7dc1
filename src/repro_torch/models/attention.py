"""Attention layers: GQA (+RoPE, sliding window) and MLA (DeepSeek-V2), the
port of ``repro.models.attention``.

Train and prefill attend through ``flash_attention``, the reference's
chunked online softmax (all softmax math in f32), which on the card is a
hand-written kernel (``kernels.flash_attn``): no [T, S] score matrix is
kept, forward or backward. Decode attends one query against a cache whose
``slot_pos`` records the absolute position each slot holds (-1 = empty).
The decode functions write the new entry into the cache tensors in place
and return them.
"""
from __future__ import annotations

import math

import torch

from repro_torch.device import resolve
from repro_torch.kernels.decode_attn.kernel import decode_attn, mla_decode_attn
from repro_torch.kernels.flash_attn.ops import FlashAttention
from repro_torch.models.common import (
    apply_norm, apply_rope, default_scale, dense_init, init_norm, mla_softmax_scale,
    model_rope_angles, rope_angles, torch_dtype,
)
from repro_torch.obs.spans import span


def flash_attention(q, k, v, *, q_offset=0, window=0, q_chunk=512, kv_chunk=512,
                    scale=None):
    """Causal attention, the reference's ``flash_attention``. q [B,T,H,Dk];
    k [B,S,Hkv,Dk]; v [B,S,Hkv,Dv] -> [B,T,H,Dv] in q's type.

    ``window`` > 0 enables sliding-window masking (key kept iff
    q_pos - window < k_pos <= q_pos). ``q_offset`` is the absolute position
    of q[0] (k positions start at 0). q-head h reads kv-head h // (H / Hkv);
    scores are scaled by ``scale``, 1/√Dk where it is None. v may be
    narrower than q and k (MLA): the result equals the reference's
    pad-v-to-Dk-then-slice. Unlike the reference, which asserts that the
    chunks divide T and S, a ragged T or S is answered, its last tile
    short."""
    return FlashAttention.apply(q, k, v, int(q_offset), int(window),
                                int(q_chunk), int(kv_chunk), scale)


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
    out = flash_attention(q, k, v, window=w)
    return out.reshape(B, T, H * D) @ p["wo"]


def decode_attention(q, k, v, slot_pos, q_pos, *, window=0):
    """One-token attention against a cache (the reference's, whose f32
    function ``kernels.decode_attn`` computes, on the card without f32
    copies of the cache).

    q [B,1,H,D]; k,v [B,S,Hkv,D] (a layer's view of the cache); slot_pos
    [B,S] absolute position held by each cache slot (-1 = empty); q_pos [B]
    absolute position of the query.
    """
    return decode_attn(q, k, v, slot_pos, q_pos, window=window)


def gqa_fill_cache(p, x, cfg):
    """Roped k and v of the whole prompt (the prefill's cache entries)."""
    B, T, _ = x.shape
    Hkv, D = cfg.num_kv_heads, cfg.resolved_head_dim
    k = (x @ p["wk"]).reshape(B, T, Hkv, D)
    v = (x @ p["wv"]).reshape(B, T, Hkv, D)
    cos, sin = rope_angles(torch.arange(T, device=x.device), D, cfg.rope_theta)
    return apply_rope(k, cos, sin), v


def gqa_decode(p, x, cache_k, cache_v, slot_pos, slot, pos, cfg, *, window=None):
    """One-token GQA. x [B,1,d]; cache_k/v [B,S,Hkv,D]; pos [B] absolute
    position; ``slot`` [B] the cache slot to write, which ``slot_pos``
    already records. Returns (out, cache_k, cache_v)."""
    B = x.shape[0]
    H, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q = (x @ p["wq"]).reshape(B, 1, H, D)
    k = (x @ p["wk"]).reshape(B, 1, Hkv, D)
    v = (x @ p["wv"]).reshape(B, 1, Hkv, D)
    cos, sin = rope_angles(pos[:, None], D, cfg.rope_theta)  # [B,1,D/2]
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    bidx = torch.arange(B, device=x.device)
    cache_k[bidx, slot] = k[:, 0]
    cache_v[bidx, slot] = v[:, 0]
    w = cfg.sliding_window if window is None else window
    out = decode_attention(q, cache_k, cache_v, slot_pos, pos, window=w)
    return out.reshape(B, 1, H * D) @ p["wo"], cache_k, cache_v


# ---------------------------------------------------------------------------
# MLA (multi-head latent attention, DeepSeek-V2)
# ---------------------------------------------------------------------------


def init_mla(gen, cfg, lead=(), device=None):
    """MLA's weights; without a query LoRA (``q_lora_rank`` 0) the query is
    one projection ``w_q`` [d, H·(dn + dr)] in place of w_dq, q_norm, w_uq."""
    device = resolve(device)
    d, H = cfg.d_model, cfg.num_heads
    r, qr = cfg.kv_lora_rank, cfg.q_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    dt = torch_dtype(cfg.dtype)
    lead = tuple(lead)
    if qr:
        q = {"w_dq": dense_init(gen, lead + (d, qr), dt, default_scale(d), device),
             "w_uq": dense_init(gen, lead + (qr, H * (dn + dr)), dt,
                                default_scale(qr), device),
             "q_norm": init_norm(cfg, qr, lead, device)}
    else:
        q = {"w_q": dense_init(gen, lead + (d, H * (dn + dr)), dt, default_scale(d), device)}
    return {
        **q,
        "w_dkv": dense_init(gen, lead + (d, r + dr), dt, default_scale(d), device),
        "kv_norm": init_norm(cfg, r, lead, device),
        "w_uk": dense_init(gen, lead + (r, H, dn), dt, default_scale(r), device),
        "w_uv": dense_init(gen, lead + (r, H, dv), dt, default_scale(r), device),
        "wo": dense_init(gen, lead + (H * dv, d), dt, default_scale(H * dv), device),
    }


def _mla_q(p, x, cfg, positions):
    B, T, _ = x.shape
    dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    if "w_q" in p:
        q = (x @ p["w_q"]).reshape(B, T, cfg.num_heads, dn + dr)
    else:
        cq = apply_norm(p["q_norm"], x @ p["w_dq"], cfg)
        q = (cq @ p["w_uq"]).reshape(B, T, cfg.num_heads, dn + dr)
    cos, sin = model_rope_angles(positions, dr, cfg)
    return q[..., :dn], apply_rope(q[..., dn:], cos, sin)


def _mla_ckv(p, x, cfg, positions):
    r, dr = cfg.kv_lora_rank, cfg.qk_rope_head_dim
    ckv_full = x @ p["w_dkv"]
    ckv = apply_norm(p["kv_norm"], ckv_full[..., :r], cfg)
    cos, sin = model_rope_angles(positions, dr, cfg)
    # k_rope [B,T,dr] is shared across heads
    k_rope = apply_rope(ckv_full[..., r:][:, :, None, :], cos, sin)[:, :, 0]
    return ckv, k_rope


def mla_forward(p, x, cfg):
    """Train/prefill MLA (the span ``mla.forward``): expand the latent to
    per-head k and v, then flash attention over q = [nope, rope] at the
    scale 1/√(dn + dr) (times YaRN's mscale² where set:
    ``common.mla_softmax_scale``). v keeps its own width (the reference pads
    it to dn + dr for its flash attention and slices the pad off again)."""
    with span("mla.forward"):
        B, T, _ = x.shape
        H = cfg.num_heads
        dr, dv = cfg.qk_rope_head_dim, cfg.v_head_dim
        positions = torch.arange(T, device=x.device)
        q_nope, q_rope = _mla_q(p, x, cfg, positions)
        ckv, k_rope = _mla_ckv(p, x, cfg, positions)
        k_nope = torch.einsum("btr,rhd->bthd", ckv, p["w_uk"])
        v = torch.einsum("btr,rhd->bthd", ckv, p["w_uv"])
        q = torch.cat([q_nope, q_rope], dim=-1)
        k = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, T, H, dr)], dim=-1)
        out = flash_attention(q, k, v, scale=mla_softmax_scale(cfg))
        return out.reshape(B, T, H * dv) @ p["wo"]


def mla_fill_cache(p, x, cfg):
    """(ckv [B,T,r], k_rope [B,T,dr]) of the whole prompt."""
    return _mla_ckv(p, x, cfg, torch.arange(x.shape[1], device=x.device))


def mla_decode(p, x, cache_ckv, cache_kr, slot_pos, slot, pos, cfg):
    """Absorbed one-token MLA: scores and output in the latent space
    (``kernels.decode_attn.mla_decode_attn``)."""
    B = x.shape[0]
    H = cfg.num_heads
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    q_nope, q_rope = _mla_q(p, x, cfg, pos[:, None])
    ckv, k_rope = _mla_ckv(p, x, cfg, pos[:, None])
    bidx = torch.arange(B, device=x.device)
    cache_ckv[bidx, slot] = ckv[:, 0]
    cache_kr[bidx, slot] = k_rope[:, 0]
    q_abs = torch.einsum("bhd,rhd->bhr", q_nope[:, 0], p["w_uk"])  # absorb W_uk
    q_rope = q_rope[:, 0]
    scale = mla_softmax_scale(cfg)
    if scale is not None:  # the kernel scales by 1/√(dn + dr): the rest goes on q
        m2 = scale * math.sqrt(dn + dr)
        q_abs = (q_abs.float() * m2).to(q_abs.dtype)
        q_rope = (q_rope.float() * m2).to(q_rope.dtype)
    o_lat = mla_decode_attn(q_abs, q_rope, cache_ckv, cache_kr, slot_pos, pos,
                            qk_head_dim=dn + dr)
    out = torch.einsum("bhr,rhd->bhd", o_lat, p["w_uv"]).reshape(B, 1, H * dv)
    return out @ p["wo"], cache_ckv, cache_kr
