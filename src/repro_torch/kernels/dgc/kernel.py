"""``update_max``, ``tail_hist`` and ``apply_mask``: the DGC passes (CUDA).

``update_max``, ``tail_hist`` and ``apply_mask`` replace the TPU kernels
of the same names in ``src/repro/kernels/dgc/kernel.py``, all with
``csrc/dgc.cu``, whose head says what bounds each on the H100
(device-memory bytes: 20 B, 4 B and 20 B per element) and how the design
keeps the outputs bitwise those of the plain versions below: σu + g as
one fused multiply-add (what the reference kernel's compiled body
computes) and v + u' as one rounded add in ``update_max``; exact int32
counts per slice of a tile, added as integers per tile and then in tile
order in f32 in ``tail_hist``, the TPU grid's own accumulation; in
``apply_mask``, ĝ as a select (v or +0.0: XLA rewrites the body's v·mask
so) and u'', v'' as f32 products with 1 - mask (a masked-in negative entry
gives -0.0).

Each wrapper launches its kernel for CUDA tensors and takes the plain
version only for CPU tensors. Operands are (rows, 1024) f32 tiles with
rows a multiple of 256, as in the reference.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.utils.fp import fma_f32

BLOCK_ROWS = 256
BLOCK_COLS = 1024
MAX_BINS = 256
HIST_SLICES = 8  # tail_hist blocks per tile (csrc/dgc.cu kHistSlices)


def _check_tiles(name, *ts):
    dev = ts[0].device
    for t in ts:
        _build.require(t.dtype == torch.float32, f"{name}: operands must be float32")
        _build.require(t.dim() == 2 and t.shape[1] == BLOCK_COLS
                       and t.shape[0] % BLOCK_ROWS == 0,
                       f"{name}: operands must be [R, {BLOCK_COLS}] with R a "
                       f"multiple of {BLOCK_ROWS}, got {tuple(t.shape)}")
        _build.require(t.shape == ts[0].shape, f"{name}: shape mismatch")
        _build.require(t.is_contiguous() and t.data_ptr() % 16 == 0,
                       f"{name}: operands must be contiguous and 16-B aligned")
        _build.require(t.device == dev, f"{name}: operands on different devices")
    _build.require(dev.type in ("cpu", "cuda"), f"{name}: device {dev}")


# ---------------------------------------------------------------------------
# update_max
# ---------------------------------------------------------------------------


def update_max_plain(u, v, g, sigma):
    """u' = σu + g (one fused multiply-add, as the reference kernel's
    compiled body computes it), v' = v + u', per-(256 x 1024)-tile
    max|v'| [R/256, 1]."""
    nb = u.shape[0] // BLOCK_ROWS
    u_new, v_new = torch.empty_like(u), torch.empty_like(v)
    bmax = torch.empty((nb, 1), dtype=torch.float32, device=u.device)
    step = 64  # tiles per chunk: bounds the f64 temporaries at full size
    for t in range(0, nb, step):
        rows = slice(t * BLOCK_ROWS, min(nb, t + step) * BLOCK_ROWS)
        u_new[rows] = fma_f32(sigma, u[rows], g[rows])
        torch.add(v[rows], u_new[rows], out=v_new[rows])
        bmax[t:t + step] = v_new[rows].abs().reshape(-1, BLOCK_ROWS * BLOCK_COLS
                                                     ).amax(dim=1, keepdim=True)
    return u_new, v_new, bmax


def update_max(u, v, g, sigma: float):
    """u, v, g [R, 1024] f32 -> (u', v', tile max [R/256, 1])."""
    _check_tiles("update_max", u, v, g)
    if u.device.type == "cpu":
        return update_max_plain(u, v, g, sigma)
    nb = u.shape[0] // BLOCK_ROWS
    uo = torch.empty_like(u)
    vo = torch.empty_like(v)
    bmax = torch.empty((nb, 1), dtype=torch.float32, device=u.device)
    rc = _build.library().rt_update_max(
        u.data_ptr(), v.data_ptr(), g.data_ptr(), float(sigma), nb,
        uo.data_ptr(), vo.data_ptr(), bmax.data_ptr(), _build.stream_of(u))
    _build.check(rc, "update_max")
    _build.count_launch(update_max, u, v, g, uo, vo, bmax)
    return uo, vo, bmax


update_max.launches = 0


# ---------------------------------------------------------------------------
# tail_hist
# ---------------------------------------------------------------------------


def tail_hist_plain(v, edges):
    """counts[b] = #{|v| >= edges[b]} as f32: exact per-tile counts, added
    tile by tile in f32 (the reference grid's accumulation order)."""
    nb = v.shape[0] // BLOCK_ROWS
    a = v.abs().reshape(nb, -1)
    tiles = torch.stack([(a >= edges[b]).sum(dim=1)
                         for b in range(edges.shape[0])], dim=1).float()
    acc = torch.zeros(edges.shape[0], dtype=torch.float32, device=v.device)
    for t in range(nb):
        acc = acc + tiles[t]
    return acc


def tail_hist(v, edges):
    """v [R, 1024] f32; edges [bins] f32, nondecreasing -> counts [bins] f32."""
    _check_tiles("tail_hist", v)
    _build.require(edges.dtype == torch.float32 and edges.dim() == 1
                   and 1 <= edges.shape[0] <= MAX_BINS,
                   f"tail_hist: edges must be float32 [bins], bins <= {MAX_BINS}")
    _build.require(edges.device == v.device, "tail_hist: edges on another device")
    if v.device.type == "cpu":
        return tail_hist_plain(v, edges)
    edges = edges.contiguous()
    nb = v.shape[0] // BLOCK_ROWS
    bins = edges.shape[0]
    # exact int32 tail counts per slice, [bins, tiles, HIST_SLICES]
    ws = torch.empty((bins, nb, HIST_SLICES), dtype=torch.int32, device=v.device)
    counts = torch.empty((bins,), dtype=torch.float32, device=v.device)
    rc = _build.library().rt_tail_hist(
        v.data_ptr(), edges.data_ptr(), bins, nb, HIST_SLICES, ws.data_ptr(),
        counts.data_ptr(), _build.stream_of(v))
    _build.check(rc, "tail_hist")
    _build.count_launch(tail_hist, v, edges, counts)
    return counts


tail_hist.launches = 0


# ---------------------------------------------------------------------------
# apply_mask
# ---------------------------------------------------------------------------


def apply_mask_plain(u, v, th):
    """mask = |v| >= th -> (v·mask, u·(1 - mask), v·(1 - mask)) with the
    reference body's signs as XLA compiles it: v·mask becomes a select
    (masked-out entries, NaN and -0.0 included, give +0.0), the other two
    stay f32 products with 1 - mask."""
    mask = v.abs() >= th
    keep = 1.0 - mask.float()
    return torch.where(mask, v, 0.0), u * keep, v * keep


def apply_mask(u, v, th):
    """u, v [R, 1024] f32; th a 0-d (or one-element) f32 tensor on their
    device, read there by the kernel -> (ĝ, u'', v''), each [R, 1024] f32."""
    _check_tiles("apply_mask", u, v)
    _build.require(torch.is_tensor(th) and th.dtype == torch.float32
                   and th.numel() == 1,
                   "apply_mask: th must be a one-element float32 tensor")
    _build.require(th.device == u.device, "apply_mask: th must lie on u's device")
    if u.device.type == "cpu":
        return apply_mask_plain(u, v, th.reshape(()))
    th = th.reshape(1).contiguous()
    ghat, uo, vo = (torch.empty_like(v) for _ in range(3))
    rc = _build.library().rt_apply_mask(
        u.data_ptr(), v.data_ptr(), th.data_ptr(), u.shape[0],
        ghat.data_ptr(), uo.data_ptr(), vo.data_ptr(), _build.stream_of(u))
    _build.check(rc, "apply_mask")
    _build.count_launch(apply_mask, u, v, th, ghat, uo, vo)
    return ghat, uo, vo


apply_mask.launches = 0
