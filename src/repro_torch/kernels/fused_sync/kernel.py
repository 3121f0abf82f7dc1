"""``block_select``: the fused threshold/mask/compaction pass (CUDA).

Replaces the TPU kernel ``src/repro/kernels/fused_sync/kernel.py:
block_select`` (body ``_select_kernel``) with ``csrc/fused_sync.cu``. What
bounds it on the H100 and what its design does about that is written at
the head of the CUDA source: it is bound by device-memory bytes (one read
of the vector, one write of the candidate slots); each tile is a cluster
of CTAs that count their candidates, exchange the counts through
distributed shared memory and scatter from registers, each slot found by
a warp ballot instead of a per-element cumsum.

The wrapper launches the kernel for CUDA tensors and takes the plain
version (``ref.block_select_ref``) only for CPU tensors.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.fused_sync.ref import (  # noqa: F401
    BLOCK_COLS, BLOCK_ELEMS, BLOCK_ROWS, block_select_ref as block_select_plain,
)

_INT32_MAX = 2**31 - 1


def block_select(x, th, cap_blk: int, n: int):
    """x f32 (read flat; positions past its end count as zeros, so no
    padding copy is needed); th a one-element f32 tensor on x's device ->
    (vals [nb, cap_blk] f32, GLOBAL idx [nb, cap_blk] int32 with ``n`` as
    the pad slot, counts [nb, 1] int32), nb = ceil(numel / BLOCK_ELEMS).
    Equal to the reference kernel on the zero-padded tiles."""
    _build.require(x.dtype == torch.float32, "block_select: x must be float32")
    _build.require(x.is_contiguous(), "block_select: x must be contiguous")
    _build.require(1 <= cap_blk <= BLOCK_ELEMS,
                   f"block_select: cap_blk must be in [1, {BLOCK_ELEMS}]")
    _build.require(torch.is_tensor(th) and th.dtype == torch.float32
                   and th.numel() == 1,
                   "block_select: th must be a one-element float32 tensor")
    _build.require(th.device == x.device,
                   "block_select: th must lie on x's device")
    xf = x.reshape(-1)
    L = xf.numel()
    nb = -(-L // BLOCK_ELEMS)
    _build.require(nb * BLOCK_ELEMS <= _INT32_MAX and 0 <= n <= _INT32_MAX,
                   "block_select: int32 global indices overflow")
    if x.device.type == "cpu":
        return block_select_plain(xf, th, cap_blk, n)
    _build.require(x.device.type == "cuda", f"block_select: device {x.device}")
    th = th.reshape(1).contiguous()
    vals = torch.empty((nb, cap_blk), dtype=torch.float32, device=x.device)
    idx = torch.empty((nb, cap_blk), dtype=torch.int32, device=x.device)
    counts = torch.empty((nb, 1), dtype=torch.int32, device=x.device)
    rc = _build.library().rt_block_select(
        xf.data_ptr(), L, th.data_ptr(), cap_blk, n, nb, vals.data_ptr(),
        idx.data_ptr(), counts.data_ptr(), _build.stream_of(x))
    _build.check(rc, "block_select")
    _build.count_launch(block_select, xf, th, vals, idx, counts)
    return vals, idx, counts


block_select.launches = 0
