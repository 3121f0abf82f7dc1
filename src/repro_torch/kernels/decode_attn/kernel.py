"""``decode_attn`` and ``mla_decode_attn``: one query token against a layer's
cache (CUDA).

Not TPU kernels: they replace the reference's plain-jnp
``decode_attention`` (``src/repro/models/attention.py:85``) and the latent
einsums of its absorbed ``mla_decode`` (``:252-260``), with
``csrc/decode_attn.cu``. The reference (and the plain version here) reads
the whole bf16 cache through f32 copies; the kernels read it in place,
once, so decode_32k's caches fit one card. What bounds them on the H100
and what the design does about it is written at the head of the source.

Each wrapper launches its kernel for CUDA tensors and takes the plain
version (``ref``) only for CPU tensors; ``meta`` tensors get the output's
shape, with nothing computed, and the kernel's cost reported
(``_build.report_cost``) as the reference's dots, as
``repro.launch.hlo_cost`` counts them (2 · numel(result) · contracted
size): 2·B·H·S·D for q·kᵀ and as much for p·v (GQA); 2·B·H·S·(r + dr) for
the scores and 2·B·H·S·r for w·ckv (MLA). Anything the kernels do not take
raises ``ValueError`` on every device; a CUDA tensor never reaches the
plain version.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attn.ref import (  # noqa: F401
    decode_attn_plain, mla_decode_attn_plain,
)

MAX_HEAD_DIM = 256  # GQA head width (csrc/decode_attn.cu: a row of chunks)
MAX_GROUP = 64  # q heads a kv head (one CTA holds them all)
MAX_LATENT = 1024  # MLA's r + dr
_DTYPES = (torch.float32, torch.bfloat16)
# split-KV: enough CTAs to fill the 132 SMs a few times over, each split
# at least MIN_SPAN slots (csrc/decode_attn.cu merges the splits)
TARGET_CTAS, MIN_SPAN = 8 * 132, 256
MLA_HEADS = 32  # heads a CTA at most in the MLA kernel (``kMlaHeads``)


def num_splits(B: int, groups: int, S: int) -> int:
    """Splits of the S slots for ``B * groups`` (batch, kv group) pairs, each
    ``ceil(S / splits)`` slots but the last, none empty."""
    n = max(1, min(-(-S // MIN_SPAN), -(-TARGET_CTAS // max(1, B * groups))))
    return -(-S // -(-S // n))


def _check_common(what, q, caches, slot_pos, q_pos, S, B):
    _build.require(q.dtype in _DTYPES and all(c.dtype == q.dtype for c in caches),
                   f"{what}: queries and cache must all be float32 or bfloat16")
    _build.require(slot_pos.shape == (B, S) and slot_pos.dtype == torch.int64,
                   f"{what}: slot_pos must be int64 [B, S] = {(B, S)}")
    _build.require(q_pos.shape == (B,) and q_pos.dtype == torch.int64,
                   f"{what}: the query positions must be int64 [B]")
    devices = {t.device for t in (q, *caches, slot_pos, q_pos)}
    _build.require(len(devices) == 1, f"{what}: operands on different devices")
    _build.require(q.device.type in ("cpu", "cuda", "meta"),
                   f"{what}: device {q.device}")
    _build.require(all(c.is_contiguous() for c in caches) and slot_pos.is_contiguous(),
                   f"{what}: the cache and slot_pos must be contiguous (a "
                   "layer's view of the cache, read in place)")
    _build.require(B >= 1 and S >= 1, f"{what}: empty input")


def check_operands(q, k, v, slot_pos, q_pos, window: int):
    """Types, shapes and layouts ``decode_attn`` takes; raises ValueError."""
    _build.require(q.dim() == 4 and k.dim() == 4 and v.dim() == 4,
                   "decode_attn: q must be [B, 1, H, D], k and v [B, S, Hkv, D]")
    B, T, H, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    _build.require(T == 1 and k.shape == (B, S, Hkv, D) and v.shape == k.shape,
                   f"decode_attn: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                   f"v {tuple(v.shape)} do not agree")
    _build.require(Hkv >= 1 and H % Hkv == 0 and H // Hkv <= MAX_GROUP,
                   f"decode_attn: q heads must be a multiple of kv heads, at "
                   f"most {MAX_GROUP} a kv head")
    _build.require(2 <= D <= MAX_HEAD_DIM and D % 2 == 0,
                   f"decode_attn: the head dim must be even, in [2, {MAX_HEAD_DIM}]")
    _check_common("decode_attn", q, (k, v), slot_pos, q_pos, S, B)
    _build.require(window >= 0, "decode_attn: window must be >= 0")


def check_mla_operands(q_abs, q_rope, ckv, kr, slot_pos, pos, qk_head_dim):
    """Types, shapes and layouts ``mla_decode_attn`` takes; raises
    ValueError."""
    _build.require(q_abs.dim() == 3 and q_rope.dim() == 3 and ckv.dim() == 3
                   and kr.dim() == 3,
                   "mla_decode_attn: q_abs [B,H,r], q_rope [B,H,dr], ckv [B,S,r], "
                   "kr [B,S,dr]")
    B, H, r = q_abs.shape
    S, dr = ckv.shape[1], kr.shape[2]
    _build.require(q_rope.shape == (B, H, dr) and ckv.shape == (B, S, r)
                   and kr.shape == (B, S, dr),
                   f"mla_decode_attn: shapes q_abs {tuple(q_abs.shape)}, q_rope "
                   f"{tuple(q_rope.shape)}, ckv {tuple(ckv.shape)}, kr "
                   f"{tuple(kr.shape)} do not agree")
    elem = q_abs.element_size()
    _build.require(H >= 1 and r >= 1 and dr >= 1 and r + dr <= MAX_LATENT
                   and r * elem % 16 == 0 and dr % 2 == 0,
                   f"mla_decode_attn: r a multiple of 16 bytes, dr even, r + dr "
                   f"<= {MAX_LATENT}; got r {r}, dr {dr}")
    _build.require(qk_head_dim > 0, "mla_decode_attn: qk_head_dim must be > 0")
    _check_common("mla_decode_attn", q_abs, (q_rope, ckv, kr), slot_pos, pos, S, B)


def decode_flops(q, k) -> float:
    """q·kᵀ and p·v as ``hlo_cost`` counts the reference's two einsums."""
    B, _, H, D = q.shape
    return 4.0 * B * H * k.shape[1] * D


def mla_flops(q_abs, q_rope, ckv) -> float:
    """The reference's three latent einsums (q_abs·ckv, q_rope·kr, w·ckv)."""
    B, H, r = q_abs.shape
    return 2.0 * B * H * ckv.shape[1] * (2 * r + q_rope.shape[2])


def _workspace(B, H, nsplit, Dv, device):
    return (torch.empty((B, H, nsplit, Dv), dtype=torch.float32, device=device),
            torch.empty((B, H, nsplit, 2), dtype=torch.float32, device=device))


def decode_attn(q, k, v, slot_pos, q_pos, *, window=0):
    """q [B,1,H,D]; k,v [B,S,Hkv,D] (a layer's cache, contiguous, q's type);
    slot_pos [B,S] int64 (-1 = empty); q_pos [B] int64 -> [B,1,H,D] in q's
    type: the reference's ``decode_attention``."""
    window = int(window)
    check_operands(q, k, v, slot_pos, q_pos, window)
    if q.device.type == "cpu":
        return decode_attn_plain(q, k, v, slot_pos, q_pos, window=window)
    B, _, H, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    flops = decode_flops(q, k)
    if q.device.type == "meta":
        _build.report_cost(decode_attn, q, k, v, slot_pos, q_pos, out, flops=flops)
        return out
    q = q.contiguous()
    nsplit = num_splits(B, Hkv, S)
    ws_acc, ws_ml = _workspace(B, H, nsplit, D, q.device)
    rc = _build.library().rt_decode_attn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), slot_pos.data_ptr(),
        q_pos.data_ptr(), out.data_ptr(), ws_acc.data_ptr(), ws_ml.data_ptr(),
        B, S, H, Hkv, D, window, nsplit, 1.0 / math.sqrt(D),
        int(q.dtype == torch.bfloat16), _build.stream_of(q))
    _build.check(rc, "decode_attn")
    _build.count_launch(decode_attn, q, k, v, slot_pos, q_pos, out, flops=flops)
    return out


decode_attn.launches = 0


def mla_decode_attn(q_abs, q_rope, ckv, kr, slot_pos, pos, *, qk_head_dim):
    """q_abs [B,H,r]; q_rope [B,H,dr]; ckv [B,S,r], kr [B,S,dr] (a layer's
    latent cache, contiguous, q_abs's type); slot_pos [B,S] int64; pos [B]
    int64; ``qk_head_dim`` = dn + dr -> o_lat [B,H,r] in q_abs's type: the
    latent part of the reference's ``mla_decode``."""
    check_mla_operands(q_abs, q_rope, ckv, kr, slot_pos, pos, qk_head_dim)
    if q_abs.device.type == "cpu":
        return mla_decode_attn_plain(q_abs, q_rope, ckv, kr, slot_pos, pos,
                                     qk_head_dim=qk_head_dim)
    B, H, r = q_abs.shape
    S, dr = ckv.shape[1], kr.shape[2]
    out = torch.empty((B, H, r), dtype=q_abs.dtype, device=q_abs.device)
    flops = mla_flops(q_abs, q_rope, ckv)
    if q_abs.device.type == "meta":
        _build.report_cost(mla_decode_attn, q_abs, q_rope, ckv, kr, slot_pos, pos,
                           out, flops=flops)
        return out
    q_abs, q_rope = q_abs.contiguous(), q_rope.contiguous()
    nsplit = num_splits(B, -(-H // MLA_HEADS), S)
    ws_acc, ws_ml = _workspace(B, H, nsplit, r, q_abs.device)
    rc = _build.library().rt_mla_decode_attn(
        q_abs.data_ptr(), q_rope.data_ptr(), ckv.data_ptr(), kr.data_ptr(),
        slot_pos.data_ptr(), pos.data_ptr(), out.data_ptr(), ws_acc.data_ptr(),
        ws_ml.data_ptr(), B, S, H, r, dr, nsplit, math.sqrt(qk_head_dim),
        int(q_abs.dtype == torch.bfloat16), _build.stream_of(q_abs))
    _build.check(rc, "mla_decode_attn")
    _build.count_launch(mla_decode_attn, q_abs, q_rope, ckv, kr, slot_pos, pos, out,
                        flops=flops)
    return out


mla_decode_attn.launches = 0
