"""``bitpack``: presence mask -> bitmap bytes + per-block popcounts (CUDA).

Replaces the TPU kernel ``src/repro/kernels/bitpack/kernel.py:bitpack``
(body ``_bitpack_kernel``) with ``csrc/bitpack.cu``, whose head states
its bound on the H100 (device-memory bytes, 4.125 B per element) and how
the design streams to it in one launch: a tile is a cluster of 8 CTAs
that keep the next chunk's float4 loads in flight while a warp's
xor-shuffles assemble LSB-first 32-bit words from the current one, and
the CTAs' popcounts meet in CTA 0's shared memory, which stores the
tile's count (no memset, no atomics).

The function is the TPU body's, not its layout: bytes come out as uint8
(the reference kept one byte per int32 lane), equal by value. A mask
entry is set when it is != 0.0: NaN is set, -0.0 is not, and a subnormal
is set, as in the codec's numpy path (XLA's CPU flushes subnormals to
zero, so the reference kernel in interpret mode reads one as unset).

The wrapper launches the kernel for CUDA tensors and takes
``bitpack_plain`` only for CPU tensors.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

LANES = 128
BLOCK_ROWS = 256  # (256, 1024) f32 tile = 1 MB, the reference's block
BLOCK_COLS = 8 * LANES  # 1024


def _check(mask):
    _build.require(mask.device.type in ("cpu", "cuda"),
                   f"bitpack: device {mask.device}")
    _build.require(mask.dtype == torch.float32, "bitpack: mask must be float32")
    _build.require(mask.dim() == 2 and mask.shape[1] == BLOCK_COLS
                   and mask.shape[0] % BLOCK_ROWS == 0,
                   f"bitpack: mask must be [R, {BLOCK_COLS}] with R a multiple "
                   f"of {BLOCK_ROWS}, got {tuple(mask.shape)}")
    _build.require(mask.is_contiguous() and mask.data_ptr() % 16 == 0,
                   "bitpack: mask must be contiguous and 16-B aligned")


def bitpack_plain(mask):
    """The TPU body in torch ops: eight strided column slices shifted and
    summed into bytes, and the popcount of every (256 x 1024) block."""
    m = (mask != 0.0).to(torch.int32)
    acc = torch.zeros((mask.shape[0], LANES), dtype=torch.int32, device=mask.device)
    for b in range(8):
        acc += m[:, b::8] << b
    counts = m.reshape(-1, BLOCK_ROWS * BLOCK_COLS).sum(dim=1, keepdim=True)
    return acc.to(torch.uint8), counts.to(torch.int32)


def bitpack(mask):
    """mask [R, 1024] f32 (nonzero = set) -> (bytes [R, 128] uint8,
    LSB-first; per-block popcounts [R/256, 1] int32)."""
    _check(mask)
    if mask.device.type == "cpu":
        return bitpack_plain(mask)
    R = mask.shape[0]
    nb = R // BLOCK_ROWS
    out = torch.empty((R, LANES), dtype=torch.uint8, device=mask.device)
    counts = torch.empty((nb, 1), dtype=torch.int32, device=mask.device)
    rc = _build.library().rt_bitpack(mask.data_ptr(), nb, out.data_ptr(),
                                     counts.data_ptr(), _build.stream_of(mask))
    _build.check(rc, "bitpack")
    _build.count_launch(bitpack, mask, out, counts)
    return out, counts


bitpack.launches = 0


def active_clusters() -> int:
    """How many of the kernel's clusters (one per tile) the card holds at
    once, from the CUDA occupancy calculator (card only)."""
    import ctypes

    n = ctypes.c_int(0)
    _build.check(_build.library().rt_bitpack_active_clusters(ctypes.byref(n)),
                 "bitpack occupancy")
    return n.value
