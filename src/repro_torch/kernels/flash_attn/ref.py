"""The plain version of the attention kernels: the reference's chunked
online softmax (``repro.models.attention.flash_attention``) literally.

For each q tile an online softmax runs over every key tile, masked ones
included: f32 scores ``(q . k) * scale`` (``scale`` 1/√Dk unless given)
masked to -1e30, m/l/acc in f32, P . V in f32, ``acc / max(l, 1e-30)``;
the forward also returns each row's log-sum-exp. The backward recomputes each q tile's sweep, as the
reference's ``jax.checkpoint(q_step)`` does, tile by tile from the saved
log-sum-exp (p = exp(s - lse)) and differentiates it in closed form: dp =
dO . V^T, ds = p (dp - rowsum(dO * O)), dq = ds . K, dk = ds^T . Q, dv =
p^T . dO, all in f32, so no tensor of T x S elements is kept (one
[*, q_chunk, kv_chunk] tile at a time). Tiles are ``q_chunk`` x
``kv_chunk``; unlike the reference, which asserts that they divide T and
S, the last tile may be short. This is the CPU path of
``kernel.flash_attn_fwd``/``flash_attn_bwd`` and their oracle on the card.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def _sweep(qb, k, v, qpos, window, kv_chunk, scale):
    """One q tile's online softmax over all key tiles. qb [B,qc,Hkv,G,Dk]
    f32, k [B,S,Hkv,Dk] f32, v [B,S,Hkv,Dv] f32, qpos [qc] -> (out
    [B,Hkv,G,qc,Dv], lse [B,Hkv,G,qc]), both f32."""
    B, qc, Hkv, G, _ = qb.shape
    S, Dv = k.shape[1], v.shape[-1]
    m = torch.full((B, Hkv, G, qc), NEG_INF, dtype=torch.float32, device=qb.device)
    l = torch.zeros((B, Hkv, G, qc), dtype=torch.float32, device=qb.device)
    acc = torch.zeros((B, Hkv, G, qc, Dv), dtype=torch.float32, device=qb.device)
    for s0 in range(0, S, kv_chunk):
        kb, vb = k[:, s0:s0 + kv_chunk], v[:, s0:s0 + kv_chunk]
        kpos = torch.arange(s0, s0 + kb.shape[1], device=qb.device)
        s = torch.einsum("bqhgd,bkhd->bhgqk", qb, kb) * scale
        mask = qpos[:, None] >= kpos[None, :]
        if window:
            mask &= kpos[None, :] > (qpos[:, None] - window)
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhgqk,bkhd->bhgqd", p, vb)
        m = m_new
    den = l.clamp_min(1e-30)
    return acc / den[..., None], m + torch.log(den)


def _tiles(q, q_offset, q_chunk):
    T = q.shape[1]
    qc = min(q_chunk, T)
    pos = q_offset + torch.arange(T, device=q.device)
    return [(t0, pos[t0:t0 + qc]) for t0 in range(0, T, qc)]


def _grouped(x, Hkv):
    """[B,t,H,D] -> [B,t,Hkv,G,D]: q-head h is (h // G, h % G)."""
    B, t, H, D = x.shape
    return x.reshape(B, t, Hkv, H // Hkv, D)


def _ungrouped(x):
    """[B,Hkv,G,t,D] -> [B,t,H,D]."""
    B, Hkv, G, t, D = x.shape
    return x.permute(0, 3, 1, 2, 4).reshape(B, t, Hkv * G, D)


def flash_attn_fwd_plain(q, k, v, *, q_offset=0, window=0, q_chunk=512,
                         kv_chunk=512, scale=None):
    """q [B,T,H,Dk], k [B,S,Hkv,Dk], v [B,S,Hkv,Dv] -> (out [B,T,H,Dv] f32,
    lse [B,H,T] f32); the scores scaled by ``scale`` (None: 1/√Dk)."""
    Hkv = k.shape[2]
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)
    kf, vf = k.float(), v.float()
    kc = min(kv_chunk, k.shape[1])
    outs, lses = [], []
    for t0, qpos in _tiles(q, q_offset, q_chunk):
        qb = _grouped(q[:, t0:t0 + qpos.shape[0]].float(), Hkv)
        o, lse = _sweep(qb, kf, vf, qpos, window, kc, scale)
        outs.append(_ungrouped(o))
        lses.append(lse.flatten(1, 2))  # [B,H,qc]
    return torch.cat(outs, dim=1), torch.cat(lses, dim=2)


def flash_attn_bwd_plain(q, k, v, o32, lse, dout, *, q_offset=0, window=0,
                         q_chunk=512, kv_chunk=512, scale=None):
    """Gradients of ``flash_attn_fwd_plain``'s output (cast to q's type)
    for the cotangent ``dout`` [B,T,H,Dv], given that forward's ``o32``
    and ``lse``: each (q tile, key tile) pair recomputed and differentiated
    in f32; dk and dv add up over the q tiles in f32 -> (dq, dk, dv) in the
    types of q, k and v."""
    B, T, H, Dk = q.shape
    Hkv = k.shape[2]
    scale = 1.0 / math.sqrt(Dk) if scale is None else float(scale)
    kc = min(kv_chunk, k.shape[1])
    kf, vf = k.float(), v.float()
    do = _grouped(dout.float(), Hkv)
    lse = lse.reshape(B, Hkv, H // Hkv, T)
    delta = (do * _grouped(o32, Hkv)).sum(-1).permute(0, 2, 3, 1)  # [B,Hkv,G,T]
    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    dqs = []
    for t0, qpos in _tiles(q, q_offset, q_chunk):
        t1 = t0 + qpos.shape[0]
        qb, dob = _grouped(q[:, t0:t1].float(), Hkv), do[:, t0:t1]
        dq = torch.zeros_like(qb)
        for s0 in range(0, kf.shape[1], kc):
            kb, vb = kf[:, s0:s0 + kc], vf[:, s0:s0 + kc]
            kpos = torch.arange(s0, s0 + kb.shape[1], device=q.device)
            s = torch.einsum("bqhgd,bkhd->bhgqk", qb, kb) * scale
            mask = qpos[:, None] >= kpos[None, :]
            if window:
                mask &= kpos[None, :] > (qpos[:, None] - window)
            p = torch.where(mask, torch.exp(s - lse[..., t0:t1, None]), 0.0)
            dp = torch.einsum("bqhge,bkhe->bhgqk", dob, vb)
            ds = p * (dp - delta[..., t0:t1, None])
            dv[:, s0:s0 + kc] += torch.einsum("bhgqk,bqhge->bkhe", p, dob)
            dk[:, s0:s0 + kc] += torch.einsum("bhgqk,bqhgd->bkhd", ds, qb) * scale
            dq += torch.einsum("bhgqk,bkhd->bqhgd", ds, kb) * scale
        dqs.append(dq.flatten(2, 3))
    return (torch.cat(dqs, dim=1).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype))
