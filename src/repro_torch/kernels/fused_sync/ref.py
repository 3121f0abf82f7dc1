"""Plain PyTorch version of the ``block_select`` kernel (same semantics).

The CPU path of ``kernel.block_select`` and the oracle the CUDA kernel is
held against on the card.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

BLOCK_ROWS = 64
BLOCK_COLS = 1024
BLOCK_ELEMS = BLOCK_ROWS * BLOCK_COLS


def block_select_ref(x, th, cap_blk: int, n: int):
    """Per-tile threshold compaction of a flat f32 vector.

    ``x`` is read flat and zero-padded to whole (64 x 1024) tiles. In each
    tile the entries with ``|x| >= th`` fill ``cap_blk`` slots in index
    order (surplus dropped); spare slots hold (0.0, ``n``). Returns
    vals [nb, cap_blk] f32, GLOBAL idx [nb, cap_blk] int32 and the true
    per-tile candidate counts [nb, 1] int32.
    """
    xf = x.reshape(-1)
    L = xf.numel()
    nb = -(-L // BLOCK_ELEMS)
    xb = F.pad(xf, (0, nb * BLOCK_ELEMS - L)).reshape(nb, BLOCK_ELEMS)
    m = xb.abs() >= th
    pos = torch.cumsum(m, dim=1, dtype=torch.int32) - 1
    keep = (m & (pos < cap_blk)).reshape(-1)
    src = keep.nonzero().squeeze(1)  # flat positions, index order
    dst = (src // BLOCK_ELEMS) * cap_blk + pos.reshape(-1)[src].long()
    vals = torch.zeros(nb * cap_blk, dtype=xf.dtype, device=xf.device)
    idx = torch.full((nb * cap_blk,), n, dtype=torch.int32, device=xf.device)
    vals[dst] = xb.reshape(-1)[src]
    idx[dst] = src.to(torch.int32)
    counts = m.sum(dim=1, dtype=torch.int32)[:, None]
    return vals.reshape(nb, cap_blk), idx.reshape(nb, cap_blk), counts
