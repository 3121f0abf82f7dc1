"""``flash_attn_fwd`` and ``flash_attn_bwd``: causal (optionally
sliding-window) GQA attention and its gradients (CUDA).

Not a TPU kernel: they replace the reference's plain-jnp
``flash_attention`` (``src/repro/models/attention.py:23``), with
``csrc/flash_attn.cu`` (the forward) and ``csrc/flash_attn_bwd.cu`` (dQ,
then dK/dV, two kernels without atomics). What bounds them on the H100
and what the design does about it is written at the head of each source.
bf16 inputs (the paths' type) go to the tensor cores: tiles streamed by
TMA through a ring in shared memory, S and dP as wgmmas, and the products
with the f32 P or dS as three wgmmas each on P or dS split exactly into
bf16 parts (``csrc/flash_attn_sm90.cuh``), so the function stays the
reference's f32 one; their head dimensions are multiples of 8 with
Dk <= 192 and Dv <= 128 (``tc_bucket`` there; ``check_operands`` refuses
other bf16 widths on every device). f32 inputs go to CUDA-core kernels
(f32 operations, the online softmax in registers), any width up to 256.
Both skip the tiles the mask empties.

Each wrapper launches its kernel for CUDA tensors and takes the plain
version (``ref``) only for CPU tensors; ``meta`` tensors get the outputs'
shapes, with nothing computed, and the kernel's cost reported
(``_build.report_cost``), so the dry-run counts attention at any length.
The flops reported are the reference's dots as ``repro.launch.hlo_cost``
counts them (2 · numel(result) · contracted size, every tile of the
T x S sweep): 2·B·H·T·S·(Dk + Dv) for the forward and three times that for
the backward (the checkpointed sweep run again, then two products per
forward product). The plain version's backward runs five of those six
products (P . V is not recomputed), and the CPU's op counter counts what
it runs.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attn.ref import (  # noqa: F401
    flash_attn_bwd_plain, flash_attn_fwd_plain,
)

MAX_HEAD_DIM = 256  # csrc/flash_attn.cuh: the f32 kernels' widest bucket
# csrc/flash_attn_sm90.cuh (tc_bucket): a bf16 head width keeps TMA's
# row strides a multiple of 16 bytes, and the widest bucket is MLA's
BF16_DIM_STEP, BF16_MAX_DK, BF16_MAX_DV = 8, 192, 128
_DTYPES = (torch.float32, torch.bfloat16)


def check_operands(q, k, v, q_offset: int, window: int):
    """Types, layouts and positions the kernels take; raises ValueError."""
    _build.require(q.dim() == 4 and k.dim() == 4 and v.dim() == 4,
                   "flash_attention: q, k, v must be [B, T|S, heads, D]")
    B, T, H, Dk = q.shape
    _, S, Hkv, _ = k.shape
    _build.require(k.shape == (B, S, Hkv, Dk) and v.shape[:3] == (B, S, Hkv),
                   f"flash_attention: shapes q {tuple(q.shape)}, k "
                   f"{tuple(k.shape)}, v {tuple(v.shape)} do not agree")
    _build.require(Hkv >= 1 and H % Hkv == 0,
                   "flash_attention: q heads must be a multiple of kv heads")
    _build.require(1 <= Dk <= MAX_HEAD_DIM and 1 <= v.shape[3] <= MAX_HEAD_DIM,
                   f"flash_attention: head dims must lie in [1, {MAX_HEAD_DIM}]")
    _build.require(T >= 1 and S >= 1 and B >= 1, "flash_attention: empty input")
    _build.require(q.dtype in _DTYPES and k.dtype == q.dtype == v.dtype,
                   "flash_attention: q, k, v must all be float32 or bfloat16")
    Dv = v.shape[3]
    _build.require(q.dtype != torch.bfloat16
                   or (Dk % BF16_DIM_STEP == 0 and Dv % BF16_DIM_STEP == 0
                       and Dk <= BF16_MAX_DK and Dv <= BF16_MAX_DV),
                   f"flash_attention: bf16 head dims must be multiples of "
                   f"{BF16_DIM_STEP} with Dk <= {BF16_MAX_DK} and Dv <= "
                   f"{BF16_MAX_DV}; got Dk {Dk}, Dv {Dv}")
    _build.require(q.device == k.device == v.device,
                   "flash_attention: q, k, v on different devices")
    _build.require(q.device.type in ("cpu", "cuda", "meta"),
                   f"flash_attention: device {q.device}")
    _build.require(q_offset >= 0 and window >= 0,
                   "flash_attention: q_offset and window must be >= 0")
    # a row with no kept key: the reference averages v over all S keys
    # there (every score -1e30); the port refuses it
    _build.require(not window or q_offset + T < S + window,
                   "flash_attention: the window leaves the last query rows "
                   "no key")


def attn_flops(q, k, v) -> float:
    """The forward's dot flops as ``hlo_cost`` counts the reference's scan."""
    B, T, H, Dk = q.shape
    return 2.0 * B * H * T * k.shape[1] * (Dk + v.shape[3])


def _launch_args(q, k, v, q_offset, window, scale):
    B, T, H, Dk = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    return (B, T, S, H, Hkv, Dk, v.shape[3], int(q_offset), int(window),
            1.0 / math.sqrt(Dk) if scale is None else float(scale),
            int(q.dtype == torch.bfloat16))


def flash_attn_fwd(q, k, v, *, q_offset=0, window=0, q_chunk=512, kv_chunk=512,
                   scale=None):
    """q [B,T,H,Dk], k [B,S,Hkv,Dk], v [B,S,Hkv,Dv] (f32 or bf16) -> (out
    [B,T,H,Dv] f32, lse [B,H,T] f32), the scores scaled by ``scale`` (None:
    1/√Dk). ``q_chunk``/``kv_chunk`` tile the plain version; the kernel has
    its own tiles."""
    check_operands(q, k, v, q_offset, window)
    B, T, H, _ = q.shape
    if q.device.type == "cpu":
        return flash_attn_fwd_plain(q, k, v, q_offset=q_offset, window=window,
                                    q_chunk=q_chunk, kv_chunk=kv_chunk, scale=scale)
    o32 = torch.empty((B, T, H, v.shape[3]), dtype=torch.float32, device=q.device)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    if q.device.type == "meta":
        _build.report_cost(flash_attn_fwd, q, k, v, o32, lse, flops=attn_flops(q, k, v))
        return o32, lse
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    rc = _build.library().rt_flash_attn_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o32.data_ptr(), lse.data_ptr(),
        *_launch_args(q, k, v, q_offset, window, scale), _build.stream_of(q))
    _build.check(rc, "flash_attn_fwd")
    _build.count_launch(flash_attn_fwd, q, k, v, o32, lse, flops=attn_flops(q, k, v))
    return o32, lse


flash_attn_fwd.launches = 0


def flash_attn_bwd(q, k, v, o32, lse, dout, *, q_offset=0, window=0,
                   q_chunk=512, kv_chunk=512, scale=None):
    """Gradients of ``flash_attn_fwd``'s output (cast to q's type) for the
    cotangent ``dout`` [B,T,H,Dv] (q's type); ``o32`` and ``lse`` are the
    forward's at the same ``scale`` -> (dq, dk, dv) in the types of q, k
    and v."""
    check_operands(q, k, v, q_offset, window)
    _build.require(dout.shape == o32.shape == q.shape[:3] + v.shape[3:]
                   and lse.shape == (q.shape[0], q.shape[2], q.shape[1]),
                   "flash_attn_bwd: dout, o32 or lse has the wrong shape")
    _build.require(dout.device == o32.device == lse.device == q.device,
                   "flash_attn_bwd: operands on different devices")
    _build.require(o32.dtype == lse.dtype == torch.float32,
                   "flash_attn_bwd: o32 and lse must be float32")
    if q.device.type == "cpu":
        return flash_attn_bwd_plain(q, k, v, o32, lse, dout, q_offset=q_offset,
                                    window=window, q_chunk=q_chunk, kv_chunk=kv_chunk,
                                    scale=scale)
    dout = dout.to(q.dtype)
    dq, dk, dv = (torch.empty(t.shape, dtype=t.dtype, device=t.device)
                  for t in (q, k, v))
    flops = 3.0 * attn_flops(q, k, v)
    if q.device.type == "meta":
        _build.report_cost(flash_attn_bwd, q, k, v, o32, lse, dout, dq, dk, dv,
                           flops=flops)
        return dq, dk, dv
    q, k, v, o32, lse, dout = (t.contiguous() for t in (q, k, v, o32, lse, dout))
    delta = torch.empty_like(lse)
    rc = _build.library().rt_flash_attn_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o32.data_ptr(), lse.data_ptr(),
        dout.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        delta.data_ptr(), *_launch_args(q, k, v, q_offset, window, scale),
        _build.stream_of(q))
    _build.check(rc, "flash_attn_bwd")
    _build.count_launch(flash_attn_bwd, q, k, v, o32, lse, dout, dq, dk, dv,
                        flops=flops)
    return dq, dk, dv


flash_attn_bwd.launches = 0
