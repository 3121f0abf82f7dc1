"""``decode_attn`` and ``mla_decode_attn``: one query token against a layer's
cache (CUDA).

Not TPU kernels: they replace the reference's plain-jnp
``decode_attention`` (``src/repro/models/attention.py:85``) and the latent
einsums of its absorbed ``mla_decode`` (``:252-260``). The reference (and
the plain version here) reads the whole bf16 cache through f32 copies; the
kernels read it in place, once, so decode_32k's caches fit one card. What
bounds them on the H100 and what the designs do about it is written at the
head of the sources.

Two kernels compute each function. ``route`` picks one from the dtype and
the widths alone, before any launch: bf16 MLA and bf16 GQA with G = H / Hkv
>= 2 take the tensor-core kernels (``csrc/decode_attn_sm90.cu``: wgmma and
TMA, the softmax weights split exactly into three bf16 parts), whose
launches ``decode_attn_tc.launches`` / ``mla_decode_attn_tc.launches``
count; f32, bf16 GQA at G = 1 (bytes-bound on the CUDA cores) and widths
the tensor-core kernels lack take the CUDA-core kernels
(``csrc/decode_attn.cu``), counted on ``decode_attn.launches`` /
``mla_decode_attn.launches``. This is a choice, not a fallback: a chosen
kernel whose launch (or TMA map) is refused raises.

Each wrapper launches a kernel for CUDA tensors and takes the plain version
(``ref``) only for CPU tensors; ``meta`` tensors get the output's shape,
with nothing computed, and the chosen kernel's cost reported
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
TENSOR_CORES, CUDA_CORES = "tensor_cores", "cuda_cores"
# csrc/decode_attn_sm90.cu: GQA's head width padded to 64 or 128; MLA's r
# in 64-column blocks (1, 2, 4 or 8) and dr in one; a CTA of 64 heads
TC_MAX_HEAD_DIM, TC_MAX_LATENT, TC_MAX_ROPE, TC_HEADS = 128, 512, 64, 64


def route(dtype, widths, group=None) -> str:
    """The kernel that decodes, from the dtype and the widths alone:
    ``TENSOR_CORES`` for bf16 MLA (``group`` None, ``widths`` (r, dr)) and
    bf16 GQA with ``group`` = H / Hkv >= 2 (``widths`` (D,)) whose widths
    are multiples of 8 (TMA's 16-byte strides) within the tensor-core
    kernels' buckets; ``CUDA_CORES`` otherwise: f32 (whose f32 products the
    reference computes exactly), G = 1 (bytes-bound on the CUDA cores) and
    the other widths."""
    limits = (TC_MAX_LATENT, TC_MAX_ROPE) if group is None else (TC_MAX_HEAD_DIM,)
    if (dtype != torch.bfloat16 or (group is not None and group < 2)
            or len(widths) != len(limits)
            or any(w % 8 or not 8 <= w <= lim for w, lim in zip(widths, limits))):
        return CUDA_CORES
    return TENSOR_CORES


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


def decode_attn(q, k, v, slot_pos, q_pos, *, window=0, cuda_cores=False):
    """q [B,1,H,D]; k,v [B,S,Hkv,D] (a layer's cache, contiguous, q's type);
    slot_pos [B,S] int64 (-1 = empty); q_pos [B] int64 -> [B,1,H,D] in q's
    type: the reference's ``decode_attention``, on the kernel ``route``
    picks (``cuda_cores`` takes the CUDA-core kernel whatever the route)."""
    window = int(window)
    check_operands(q, k, v, slot_pos, q_pos, window)
    B, _, H, D = q.shape
    tc = not cuda_cores and route(q.dtype, (D,), H // k.shape[2]) == TENSOR_CORES
    return _decode(q, k, v, slot_pos, q_pos, window, tc)


def decode_attn_tc(q, k, v, slot_pos, q_pos, *, window=0):
    """``decode_attn`` on the tensor-core kernel, which ``route`` picks for
    bf16 GQA at G >= 2; raises ValueError where it picks the CUDA cores.
    ``decode_attn_tc.launches`` counts that kernel's launches."""
    window = int(window)
    check_operands(q, k, v, slot_pos, q_pos, window)
    _build.require(route(q.dtype, (q.shape[3],), q.shape[2] // k.shape[2]) == TENSOR_CORES,
                   "decode_attn_tc: the tensor-core kernel takes bf16, G >= 2 and "
                   f"D a multiple of 8 up to {TC_MAX_HEAD_DIM}")
    return _decode(q, k, v, slot_pos, q_pos, window, True)


def _decode(q, k, v, slot_pos, q_pos, window, tc):
    if q.device.type == "cpu":
        return decode_attn_plain(q, k, v, slot_pos, q_pos, window=window)
    B, _, H, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    flops = decode_flops(q, k)
    fn = decode_attn_tc if tc else decode_attn
    if q.device.type == "meta":
        _build.report_cost(fn, q, k, v, slot_pos, q_pos, out, flops=flops)
        return out
    q = q.contiguous()
    nsplit = num_splits(B, Hkv, S)
    ws_acc, ws_ml = _workspace(B, H, nsplit, D, q.device)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), slot_pos.data_ptr(),
            q_pos.data_ptr(), out.data_ptr(), ws_acc.data_ptr(), ws_ml.data_ptr(),
            B, S, H, Hkv, D, window, nsplit, 1.0 / math.sqrt(D))
    if tc:
        rc = _build.library().rt_decode_attn_tc(*ptrs, _build.stream_of(q))
    else:
        rc = _build.library().rt_decode_attn(*ptrs, int(q.dtype == torch.bfloat16),
                                             _build.stream_of(q))
    _build.check(rc, fn.__name__)
    _build.count_launch(fn, q, k, v, slot_pos, q_pos, out, flops=flops)
    return out


decode_attn.launches = 0
decode_attn_tc.launches = 0


def mla_decode_attn(q_abs, q_rope, ckv, kr, slot_pos, pos, *, qk_head_dim,
                    cuda_cores=False):
    """q_abs [B,H,r]; q_rope [B,H,dr]; ckv [B,S,r], kr [B,S,dr] (a layer's
    latent cache, contiguous, q_abs's type); slot_pos [B,S] int64; pos [B]
    int64; ``qk_head_dim`` = dn + dr -> o_lat [B,H,r] in q_abs's type: the
    latent part of the reference's ``mla_decode``, on the kernel ``route``
    picks (``cuda_cores`` takes the CUDA-core kernel whatever the route)."""
    check_mla_operands(q_abs, q_rope, ckv, kr, slot_pos, pos, qk_head_dim)
    tc = (not cuda_cores
          and route(q_abs.dtype, (ckv.shape[2], kr.shape[2])) == TENSOR_CORES)
    return _mla(q_abs, q_rope, ckv, kr, slot_pos, pos, qk_head_dim, tc)


def mla_decode_attn_tc(q_abs, q_rope, ckv, kr, slot_pos, pos, *, qk_head_dim):
    """``mla_decode_attn`` on the tensor-core kernel, which ``route`` picks
    for bf16 with r and dr multiples of 8, r <= 512 and dr <= 64; raises
    ValueError where it picks the CUDA cores.
    ``mla_decode_attn_tc.launches`` counts that kernel's launches."""
    check_mla_operands(q_abs, q_rope, ckv, kr, slot_pos, pos, qk_head_dim)
    _build.require(route(q_abs.dtype, (ckv.shape[2], kr.shape[2])) == TENSOR_CORES,
                   "mla_decode_attn_tc: the tensor-core kernel takes bf16 and r, dr "
                   f"multiples of 8 up to {TC_MAX_LATENT}, {TC_MAX_ROPE}")
    return _mla(q_abs, q_rope, ckv, kr, slot_pos, pos, qk_head_dim, True)


def _mla(q_abs, q_rope, ckv, kr, slot_pos, pos, qk_head_dim, tc):
    if q_abs.device.type == "cpu":
        return mla_decode_attn_plain(q_abs, q_rope, ckv, kr, slot_pos, pos,
                                     qk_head_dim=qk_head_dim)
    B, H, r = q_abs.shape
    S, dr = ckv.shape[1], kr.shape[2]
    out = torch.empty((B, H, r), dtype=q_abs.dtype, device=q_abs.device)
    flops = mla_flops(q_abs, q_rope, ckv)
    fn = mla_decode_attn_tc if tc else mla_decode_attn
    if q_abs.device.type == "meta":
        _build.report_cost(fn, q_abs, q_rope, ckv, kr, slot_pos, pos, out, flops=flops)
        return out
    q_abs, q_rope = q_abs.contiguous(), q_rope.contiguous()
    if tc:  # CTAs a batch row: 64-head chunks x column halves (r > 256: two)
        nsplit = num_splits(B, -(-H // TC_HEADS) * -(-r // 256), S)
    else:
        nsplit = num_splits(B, -(-H // MLA_HEADS), S)
    ws_acc, ws_ml = _workspace(B, H, nsplit, r, q_abs.device)
    ptrs = (q_abs.data_ptr(), q_rope.data_ptr(), ckv.data_ptr(), kr.data_ptr(),
            slot_pos.data_ptr(), pos.data_ptr(), out.data_ptr(), ws_acc.data_ptr(),
            ws_ml.data_ptr(), B, S, H, r, dr, nsplit, math.sqrt(qk_head_dim))
    if tc:
        rc = _build.library().rt_mla_decode_attn_tc(*ptrs, _build.stream_of(q_abs))
    else:
        rc = _build.library().rt_mla_decode_attn(*ptrs, int(q_abs.dtype == torch.bfloat16),
                                                 _build.stream_of(q_abs))
    _build.check(rc, fn.__name__)
    _build.count_launch(fn, q_abs, q_rope, ckv, kr, slot_pos, pos, out, flops=flops)
    return out


mla_decode_attn.launches = 0
mla_decode_attn_tc.launches = 0
