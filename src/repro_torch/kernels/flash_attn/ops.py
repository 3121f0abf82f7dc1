"""The autograd function behind ``models.attention.flash_attention``, around
the attention kernels (``kernel.flash_attn_fwd`` and ``kernel.flash_attn_bwd``).

The forward saves q, k, v, the f32 output and the per-row log-sum-exp,
never a score matrix; the backward hands them to ``flash_attn_bwd``. On the
CPU both go to the plain version, whose backward runs each q tile's sweep
again (the reference's ``jax.checkpoint(q_step)``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attn import kernel as K


class FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, q_offset, window, q_chunk, kv_chunk, scale=None):
        ctx.opts = dict(q_offset=q_offset, window=window, q_chunk=q_chunk,
                        kv_chunk=kv_chunk, scale=scale)
        o32, lse = K.flash_attn_fwd(q, k, v, **ctx.opts)
        ctx.save_for_backward(q, k, v, o32, lse)
        return o32.to(q.dtype)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, o32, lse = ctx.saved_tensors
        dq, dk, dv = K.flash_attn_bwd(q, k, v, o32, lse, dout, **ctx.opts)
        return dq, dk, dv, None, None, None, None, None

