"""``sgdm_update``: momentum SGD's update of one leaf in one pass (CUDA).

Replaces no TPU kernel: the reference's SGDM is jnp under jit, which XLA
fuses. On the card it replaces the port's plain route, ``sgdm_plain``: the
torch ops of ``optim.SGDM``, eight passes a leaf with an f32 temporary
between each. ``csrc/sgdm.cu`` holds the kernel; its head says what bounds it
on the H100 (14 B an entry of a bf16 param).

Both routes round alike, bit for bit: f32(g), the weight decay's product and
sum (only on leaves with ndim >= 2; a 1-D leaf gets ``+ 0.0`` when the decay
is nonzero, as the torch ops add a scalar 0.0), m·μ then + g, Nesterov's
g + μ·m, and p − lr·step rounded once to the param's dtype, each in f32 and
none contracted into an fma. ``lr``, ``momentum`` and ``weight_decay`` enter
as the f32 values torch takes from the Python floats.

``optim.SGDM`` routes by device: every CUDA leaf to ``sgdm_update``, which
raises on a leaf that ``takes`` refuses (nothing falls back); every other
leaf (the CPU, ``meta``) to ``sgdm_plain``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

PARAM_DTYPES = (torch.bfloat16, torch.float32)
# the per-leaf weight-decay term (csrc Decay)
NO_DECAY, DECAY, ADD_ZERO = 0, 1, 2


def decay_mode(p, weight_decay) -> int:
    if not weight_decay:
        return NO_DECAY
    return DECAY if p.ndim >= 2 else ADD_ZERO


def takes(g, m, p) -> bool:
    """Whether ``sgdm_update`` takes the leaf (grad, moment, param): on CUDA,
    contiguous, an f32 moment and a bf16 or f32 param whose grad has its
    dtype."""
    return (p.device.type == "cuda" and g.device == p.device == m.device
            and p.dtype in PARAM_DTYPES and g.dtype == p.dtype
            and m.dtype == torch.float32 and g.shape == p.shape == m.shape
            and g.is_contiguous() and m.is_contiguous() and p.is_contiguous())


def sgdm_plain(g, m, p, lr, momentum, weight_decay, nesterov):
    """One leaf's update in torch ops, in place on ``m`` and ``p``."""
    g = g.float()
    if weight_decay:
        g = g + (weight_decay * p.float() if p.ndim >= 2 else 0.0)
    m.mul_(momentum).add_(g)
    step = (g + momentum * m) if nesterov else m
    p.copy_((p.float() - lr * step).to(p.dtype))


def sgdm_update(g, m, p, lr, momentum, weight_decay, nesterov):
    """One leaf's update on the card, in place on ``m`` and ``p``: one
    launch, none for a leaf of size 0."""
    _build.require(takes(g, m, p), "sgdm_update: the leaf must be a contiguous "
                   "CUDA grad and param of one dtype (bfloat16 or float32) with a "
                   "float32 moment of their shape")
    if not p.numel():
        return
    rc = _build.library().rt_sgdm(
        g.data_ptr(), m.data_ptr(), p.data_ptr(), p.numel(), decay_mode(p, weight_decay),
        int(p.dtype == torch.bfloat16), float(lr), float(momentum), float(weight_decay),
        int(bool(nesterov)), _build.stream_of(p))
    _build.check(rc, "sgdm")
    _build.count_launch(sgdm_update, g, m, p, m, p)


sgdm_update.launches = 0
