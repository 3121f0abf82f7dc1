"""The plain versions of the decode attention kernels: the reference's
one-token attention against a cache, as ``models.attention`` wrote it
before the kernels (``repro.models.attention.decode_attention`` and the
latent part of ``mla_decode``).

Every score is an f32 dot, masked where the slot is empty, in the future
or (with a window) too old to the finite -1e30, then softmaxed over all
S slots and multiplied with the f32 values. A query with no valid slot at
all averages the values over every slot, as the reference's does. The
whole layer cache is read through f32 copies. This is the CPU path of
``kernel.decode_attn``/``kernel.mla_decode_attn`` and their oracle on the
card.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def valid_slots(slot_pos, q_pos, window=0):
    """[B, S] bool: slots that hold a position the query may attend."""
    valid = (slot_pos >= 0) & (slot_pos <= q_pos[:, None])
    if window:
        valid &= slot_pos > (q_pos[:, None] - window)
    return valid


def decode_attn_plain(q, k, v, slot_pos, q_pos, *, window=0):
    """q [B,1,H,D]; k,v [B,S,Hkv,D]; slot_pos [B,S] absolute position held by
    each cache slot (-1 = empty); q_pos [B] absolute position of the query
    -> [B,1,H,D] in q's type."""
    B, _, H, D = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    qg = q.float().reshape(B, Hkv, G, D)
    s = torch.einsum("bhgd,bkhd->bhgk", qg, k.float()) * (1.0 / math.sqrt(D))
    valid = valid_slots(slot_pos, q_pos, window)
    s = s.masked_fill(~valid[:, None, None], NEG_INF)
    out = torch.einsum("bhgk,bkhd->bhgd", torch.softmax(s, dim=-1), v.float())
    return out.reshape(B, 1, H, D).to(q.dtype)


def mla_decode_attn_plain(q_abs, q_rope, ckv, kr, slot_pos, pos, *, qk_head_dim):
    """MLA's absorbed decode in the latent space. q_abs [B,H,r] (W_uk
    absorbed); q_rope [B,H,dr]; ckv [B,S,r], kr [B,S,dr] the latent cache;
    ``qk_head_dim`` = dn + dr, whose square root divides the scores ->
    o_lat [B,H,r] in q_abs's type."""
    ckv_f = ckv.float()
    s = (torch.einsum("bhr,bsr->bhs", q_abs.float(), ckv_f)
         + torch.einsum("bhd,bsd->bhs", q_rope.float(), kr.float())
         ) / math.sqrt(qk_head_dim)
    valid = valid_slots(slot_pos, pos)
    w = torch.softmax(s.masked_fill(~valid[:, None], NEG_INF), dim=-1)
    return torch.einsum("bhs,bsr->bhr", w, ckv_f).to(q_abs.dtype)
