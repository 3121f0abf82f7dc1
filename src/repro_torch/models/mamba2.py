"""Mamba2 block (state-space duality, arXiv:2405.21060): the port of
``repro.models.mamba2``.

The SSD scan is chunked: within a chunk the terms are dense (Q x Q) masked
products, and a Python loop over chunks carries the state between them (the
reference's ``lax.scan``). ``ssd_sequential`` is the step-by-step oracle the
tests hold it against, and ``ssd_step`` serves one-token decode with O(1)
state. All SSD math is f32, as in the reference. B and C stay [.., G, N]
and heads are factored as (G, H/G), never repeated across heads.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.device import resolve
from repro_torch.models.common import dense_init, torch_dtype

# ---------------------------------------------------------------------------
# SSD core
# ---------------------------------------------------------------------------


def ssd_chunked(x, dt, A, Bm, Cm, D, chunk):
    """x [B,T,H,P]; dt [B,T,H] (>0); A [H] (<0); Bm,Cm [B,T,G,N]; D [H].

    Returns (y [B,T,H,P], final_state [B,H,P,N])."""
    Bb, T, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    Hg = H // G
    Q = min(chunk, T)
    T_orig = T
    if T % Q:  # pad with dt = 0 steps (decay 1, no state update; rows cut)
        pad = Q - T % Q
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, 0, 0, pad))
        T = T + pad
    nc = T // Q

    xf = x.float().reshape(Bb, nc, Q, G, Hg, P)
    dtf = dt.float().reshape(Bb, nc, Q, G, Hg)
    a = dtf * A.float().reshape(G, Hg)  # log-decay (negative)
    Bf = Bm.float().reshape(Bb, nc, Q, G, N)
    Cf = Cm.float().reshape(Bb, nc, Q, G, N)
    mask = torch.tril(torch.ones(Q, Q, dtype=torch.bool, device=x.device))
    mask = mask[None, :, :, None, None]

    h = x.new_zeros((Bb, G, Hg, P, N), dtype=torch.float32)
    ys = []
    for c in range(nc):
        xc, dtc, Bc, Cc = xf[:, c], dtf[:, c], Bf[:, c], Cf[:, c]
        acs = torch.cumsum(a[:, c], dim=1)  # [B,Q,G,Hg]
        # contribution of the carried state h [B,G,Hg,P,N]
        y_inter = torch.einsum("bqgn,bghpn->bqghp", Cc, h) * acs.exp()[..., None]
        # intra-chunk (masked quadratic); mask BEFORE exp: masked entries
        # would overflow exp and poison the gradients
        seg = acs[:, :, None] - acs[:, None]  # [B,q,s,G,Hg]
        L = torch.exp(torch.where(mask, seg, 0.0)) * mask
        CB = torch.einsum("bqgn,bsgn->bqsg", Cc, Bc)
        M = CB[..., None] * L * dtc[:, None]  # [B,q,s,G,Hg]
        y_intra = torch.einsum("bqsgh,bsghp->bqghp", M, xc)
        # end-of-chunk state
        a_tot = acs[:, -1]  # [B,G,Hg]
        decay_out = torch.exp(a_tot[:, None] - acs)  # [B,Q,G,Hg]
        dBx = torch.einsum("bsgn,bsghp->bghpn", Bc,
                           xc * (dtc * decay_out)[..., None])
        h = a_tot.exp()[..., None, None] * h + dBx
        ys.append(y_inter + y_intra)
    y = torch.stack(ys, dim=1).reshape(Bb, T, H, P)[:, :T_orig]
    y = y + xf.reshape(Bb, T, H, P)[:, :T_orig] * D.float()[None, None, :, None]
    return y.to(x.dtype), h.reshape(Bb, H, P, N)


def ssd_sequential(x, dt, A, Bm, Cm, D):
    """Step-by-step oracle. Same signature and returns as ``ssd_chunked``."""
    Bb, T, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    Bh = Bm.float().repeat_interleave(rep, dim=2)
    Ch = Cm.float().repeat_interleave(rep, dim=2)
    xf, dtf, Af = x.float(), dt.float(), A.float()
    h = x.new_zeros((Bb, H, P, N), dtype=torch.float32)
    ys = []
    for t in range(T):
        dA = torch.exp(dtf[:, t] * Af)  # [B,H]
        h = h * dA[..., None, None] + torch.einsum(
            "bhn,bhp->bhpn", Bh[:, t] * dtf[:, t, :, None], xf[:, t])
        ys.append(torch.einsum("bhn,bhpn->bhp", Ch[:, t], h))
    y = torch.stack(ys, dim=1) + xf * D.float()[None, None, :, None]
    return y.to(x.dtype), h


def ssd_step(h, xt, dtt, A, Bt, Ct, D):
    """One decode step. h [B,H,P,N]; xt [B,H,P]; dtt [B,H]; Bt,Ct [B,G,N]."""
    rep = xt.shape[1] // Bt.shape[1]
    Bh = Bt.float().repeat_interleave(rep, dim=1)
    Ch = Ct.float().repeat_interleave(rep, dim=1)
    dtf, xf = dtt.float(), xt.float()
    dA = torch.exp(dtf * A.float())
    h = h * dA[..., None, None] + torch.einsum("bhn,bhp->bhpn",
                                               Bh * dtf[..., None], xf)
    y = torch.einsum("bhn,bhpn->bhp", Ch, h) + xf * D.float()[None, :, None]
    return h, y.to(xt.dtype)


# ---------------------------------------------------------------------------
# Mamba2 block (in-proj, depthwise conv, SSD, gated norm, out-proj)
# ---------------------------------------------------------------------------


def mamba2_dims(cfg):
    d_inner = cfg.ssm_expand * cfg.d_model
    H = d_inner // cfg.ssm_headdim
    G, N = cfg.ssm_ngroups, cfg.ssm_state
    d_conv = d_inner + 2 * G * N  # the conv runs over x, B, C jointly
    return d_inner, H, G, N, d_conv


def init_mamba2(gen, cfg, lead=(), device=None):
    device = resolve(device)
    d = cfg.d_model
    d_inner, H, G, N, d_conv = mamba2_dims(cfg)
    dt = torch_dtype(cfg.dtype)
    lead = tuple(lead)
    d_in_proj = 2 * d_inner + 2 * G * N + H  # z, xBC, dt
    f32 = dict(dtype=torch.float32, device=device)
    A_log = torch.log(torch.linspace(1.0, 16.0, H, **f32))
    return {
        "in_proj": dense_init(gen, lead + (d, d_in_proj), dt,
                              1.0 / math.sqrt(d), device),
        "conv_w": dense_init(gen, lead + (cfg.ssm_conv_width, d_conv), dt,
                             0.1, device),
        "conv_b": torch.zeros(lead + (d_conv,), dtype=dt, device=device),
        "A_log": A_log.expand(lead + (H,)).clone(),
        "D": torch.ones(lead + (H,), **f32),
        "dt_bias": torch.zeros(lead + (H,), **f32),
        "norm_scale": torch.ones(lead + (d_inner,), **f32),
        "out_proj": dense_init(gen, lead + (d_inner, d), dt,
                               1.0 / math.sqrt(d_inner), device),
    }


def _split_proj(proj, cfg):
    d_inner, H, G, N, _ = mamba2_dims(cfg)
    z = proj[..., :d_inner]
    xBC = proj[..., d_inner:2 * d_inner + 2 * G * N]
    dt_raw = proj[..., -H:]
    return z, xBC, dt_raw


def _gated_norm(y, z, scale, eps):
    yf = y.float() * F.silu(z.float())
    rms = torch.sqrt((yf * yf).mean(-1, keepdim=True) + eps)
    return (yf / rms * scale).to(y.dtype)


def _causal_conv(xBC, w, b):
    """Depthwise causal conv over time. xBC [B,T,Cc]; w [W,Cc]."""
    W, T = w.shape[0], xBC.shape[1]
    pad = F.pad(xBC, (0, 0, W - 1, 0))
    out = pad[:, 0:T] * w[0]
    for i in range(1, W):
        out = out + pad[:, i:i + T] * w[i]
    return F.silu(out + b)


def _ssm_inputs(p, xBC, dt_raw, cfg):
    """conv output -> (x [.., H, P], B, C [.., G, N], dt, A) of the SSD."""
    d_inner, H, G, N, _ = mamba2_dims(cfg)
    lead = xBC.shape[:-1]
    xs = xBC[..., :d_inner].reshape(*lead, H, cfg.ssm_headdim)
    Bm = xBC[..., d_inner:d_inner + G * N].reshape(*lead, G, N)
    Cm = xBC[..., d_inner + G * N:].reshape(*lead, G, N)
    dt = F.softplus(dt_raw.float() + p["dt_bias"])
    return xs, Bm, Cm, dt, -torch.exp(p["A_log"])


def mamba2_forward(p, x, cfg, *, return_state=False):
    """x [B,T,d_model] -> [B,T,d_model].

    With ``return_state=True`` also returns (final_ssm_state, conv_tail):
    the tail is the last W-1 *raw* xBC inputs (the decode conv buffer),
    left-padded with zeros when T < W-1."""
    B, T, _ = x.shape
    d_inner = mamba2_dims(cfg)[0]
    z, xBC_raw, dt_raw = _split_proj(x @ p["in_proj"], cfg)
    xBC = _causal_conv(xBC_raw, p["conv_w"], p["conv_b"])
    xs, Bm, Cm, dt, A = _ssm_inputs(p, xBC, dt_raw, cfg)
    y, state = ssd_chunked(xs, dt, A, Bm, Cm, p["D"], cfg.ssm_chunk)
    out = _gated_norm(y.reshape(B, T, d_inner), z, p["norm_scale"],
                      cfg.norm_eps) @ p["out_proj"]
    if return_state:
        W = cfg.ssm_conv_width
        pad = max(W - 1 - T, 0)
        tail = xBC_raw[:, T - (W - 1 - pad):, :]
        if pad:
            tail = F.pad(tail, (0, 0, pad, 0))
        return out, state, tail
    return out


def mamba2_decode(p, x, conv_buf, state, cfg):
    """One-token step. x [B,1,d]; conv_buf [B,W-1,Cc]; state [B,H,P,N]
    -> (out [B,1,d], new conv_buf, new state)."""
    B = x.shape[0]
    d_inner = mamba2_dims(cfg)[0]
    z, xBC, dt_raw = _split_proj((x @ p["in_proj"])[:, 0], cfg)  # [B, *]
    hist = torch.cat([conv_buf, xBC[:, None, :]], dim=1)  # [B,W,Cc]
    conv_out = F.silu(torch.einsum("bwc,wc->bc", hist, p["conv_w"]) + p["conv_b"])
    xt, Bt, Ct, dt, A = _ssm_inputs(p, conv_out, dt_raw, cfg)
    state, y = ssd_step(state, xt, dt, A, Bt, Ct, p["D"])
    out = _gated_norm(y.reshape(B, d_inner), z, p["norm_scale"],
                      cfg.norm_eps) @ p["out_proj"]
    return out[:, None, :], hist[:, 1:], state
