"""Flat-mask glue around the ``bitpack`` kernel (``repro.kernels.bitpack.ops``).

Pads an arbitrary flat mask into (256 x 1024) f32 tiles (a padding copy,
as ``kernels/dgc/ops._to_tiles``), takes the bitmap bytes, and compacts
the value stream with the kernel's popcounts. A tensor is read where it
lies; anything else (a numpy array, a list) is placed on
``device.resolve(device)``, the card unless the caller names the CPU, as
``BitmapCodec.encode`` does. The kernel's CPU path is its plain version.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.device import resolve
from repro_torch.kernels.bitpack import kernel as K

_BLOCK_ELEMS = K.BLOCK_ROWS * K.BLOCK_COLS


def _as_tensor(a, device) -> torch.Tensor:
    if torch.is_tensor(a):
        return a
    return torch.from_numpy(np.array(a)).to(resolve(device))


def _to_tiles(x):
    n = x.numel()
    pad = (-n) % _BLOCK_ELEMS
    xf = F.pad(x.reshape(-1).float(), (0, pad))
    return xf.reshape(-1, K.BLOCK_COLS), n


def _bitpack_flat(mask):
    """-> (byte vector [padded n / 8] uint8, block popcounts, n)."""
    tiles, n = _to_tiles(mask)
    byte_mat, counts = K.bitpack(tiles)
    return byte_mat.reshape(-1), counts, n


def bitpack_bytes(mask, *, device=None) -> bytes:
    """Flat mask (nonzero = set bit) -> the bitmap byte stream, identical to
    ``ref.bitpack_ref`` / ``np.packbits(bitorder="little")``."""
    byte_vec, _, n = _bitpack_flat(_as_tensor(mask, device))
    return byte_vec[: (n + 7) // 8].cpu().numpy().tobytes()


def bitmap_payload(x, *, device=None):
    """Dense flat vector -> (bitmap bytes, set-entry values in index order
    as a numpy f32 array).

    The kernel packs the presence bits (x != 0) and counts them per block;
    k, their sum, is read once on the host. The value compaction is a
    cumsum + scatter over the vector, sized by k: slot k takes every
    unset entry and is dropped."""
    x = _as_tensor(x, device).reshape(-1).float()
    mask = x != 0.0
    byte_vec, counts, n = _bitpack_flat(mask)
    k = int(counts.sum())
    packed = byte_vec[: (n + 7) // 8].cpu().numpy().tobytes()
    if k == 0:
        return packed, np.zeros(0, np.float32)
    pos = torch.cumsum(mask.to(torch.int64), 0) - 1
    tgt = torch.where(mask, pos, k)
    vals = torch.zeros((k + 1,), dtype=torch.float32, device=x.device)
    vals.scatter_(0, tgt, x)
    return packed, vals[:k].cpu().numpy()
