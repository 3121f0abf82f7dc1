"""``radix_select``: the exact stable top-k of one f32 row by |x| (CUDA).

Replaces no TPU kernel: the reference takes ``lax.top_k``; on the card it
replaces the port's ``torch.bincount`` radix select
(``core.sparsify.stable_topk_positions`` on the CPU), whose histogram
serialises where a drift row's keys crowd and whose every digit is read
back on the host. ``csrc/radix_select.cu`` holds the kernels; its head
says what bounds them on the H100 (device-memory bytes: five reads of the
row, k positions and keys written) and how the design keeps counting from
serialising and every step on the device.

``radix_select`` gives the winners as the kernels write them: every key
above t (the k-th largest |x| key) in index order, then the first ``need``
keys equal to t. ``order_winners`` sorts them stably by descending key, so
``radix_topk`` is the first k of a stable descending argsort of |x|,
``lax.top_k``'s answer, ties included.

``radix_select_plain`` follows the kernels tile by tile: per-tile
histograms summed into the row's, the digit pick of each pass's last
block, per-tile counts of keys > t and == t, their exclusive scans and the
ordered write. The wrapper launches the kernels for CUDA tensors and takes
the plain version only for CPU tensors.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

TILE = 8192  # elements a tile of the extraction (csrc kTile)
PASSES = ((20, 11), (10, 10), (0, 10))  # (shift, bits) of the digits, from the top
WS_WORDS = 2048 + 1024 + 1024 + 3  # the passes' histograms and the select's state
_STEP_TILES = 1 << 13  # tiles a step of the plain version: bounds its temporaries


def abs_keys(x):
    """int32 keys ordered like |x|: the f32 bit pattern without its sign."""
    return x.contiguous().view(torch.int32) & 0x7FFFFFFF


def _steps(n: int):
    """Element ranges [a, b) of whole tiles (the last one ragged)."""
    step = TILE * _STEP_TILES
    for a in range(0, n, step):
        yield a, min(a + step, n)


def _tiles(keys, a: int, b: int):
    """keys[a:b] as rows of TILE, the last padded with -1: no key, so never
    on a prefix, above t or equal to it."""
    kt = keys[a:b]
    pad = -kt.numel() % TILE
    if pad:
        kt = torch.cat([kt, kt.new_full((pad,), -1)])
    return kt.view(-1, TILE)


def pick_digit(hist, kr: int):
    """A pass's digit: the largest d with at least kr keys at or above it
    -> (d, kr less the keys with a larger digit)."""
    ge = hist.flip(0).cumsum(0).flip(0)  # keys with a digit >= d
    d = int((ge >= kr).nonzero().max())
    return d, kr - int(ge[d] - hist[d])


def radix_select_plain(x, k: int):
    """The kernels' result (see ``radix_select``) from plain tensor code."""
    keys = abs_keys(x.reshape(-1))
    n = keys.numel()
    dev = keys.device
    prefix, kr = 0, k
    for shift, bits in PASSES:
        hi, bins = shift + bits, 1 << bits
        hist = torch.zeros(bins, dtype=torch.int64, device=dev)
        for a, b in _steps(n):
            kt = _tiles(keys, a, b)
            on = (kt >> hi) == (prefix >> hi)  # the keys still in the running
            cell = torch.arange(kt.shape[0], device=dev)[:, None] * bins + (
                (kt >> shift) & (bins - 1))
            hist += torch.bincount(cell[on], minlength=kt.numel() // TILE * bins).view(
                -1, bins).sum(0)  # per-tile histograms, summed
        d, kr = pick_digit(hist, kr)
        prefix |= d << shift
    t, need = prefix, kr
    cnt = torch.cat([torch.stack([(kt > t).sum(1), (kt == t).sum(1)], 1)
                     for kt in (_tiles(keys, a, b) for a, b in _steps(n))])
    off = cnt.cumsum(0) - cnt  # exclusive scans over the tiles
    pos = torch.empty((k,), dtype=torch.int64, device=dev)
    out = torch.empty((k,), dtype=torch.int32, device=dev)
    for a, b in _steps(n):
        kt = _tiles(keys, a, b)
        rows = slice(a // TILE, a // TILE + kt.shape[0])
        at = a + torch.arange(kt.numel(), device=dev).view_as(kt)
        gt = kt > t
        slot = (off[rows, :1] + gt.cumsum(1) - 1)[gt]
        pos[slot], out[slot] = at[gt], kt[gt]
        eq = kt == t
        slot = off[rows, 1:] + eq.cumsum(1) - 1
        take = eq & (slot < need)
        pos[k - need + slot[take]] = at[take]
        out[k - need + slot[take]] = t
    return pos, out


def radix_select(x, k: int):
    """x 1-D f32, contiguous, 1 <= k <= numel -> (pos [k] int64, keys [k]
    int32): every position whose |x| key exceeds t, the k-th largest key,
    in index order, then the first ``need`` positions whose key is t (need:
    the keys equal to t inside the top k), with their keys."""
    _build.require(x.dtype == torch.float32 and x.dim() == 1,
                   "radix_select: x must be a 1-D float32 tensor")
    _build.require(x.is_contiguous(), "radix_select: x must be contiguous")
    n = x.numel()
    _build.require(1 <= k <= n, f"radix_select: k must be in [1, {n}], got {k}")
    if x.device.type == "cpu":
        return radix_select_plain(x, k)
    dev = x.device
    s = x.data_ptr() % 16 // 4  # the row's offset in its first 16-B chunk
    tiles = -(-(n + s) // TILE)
    ws = torch.empty((WS_WORDS,), dtype=torch.int64, device=dev)
    cnt = torch.empty((tiles, 2), dtype=torch.int32, device=dev)
    off = torch.empty((tiles, 2), dtype=torch.int64, device=dev)
    pos = torch.empty((k,), dtype=torch.int64, device=dev)
    keys = torch.empty((k,), dtype=torch.int32, device=dev)
    rc = _build.library().rt_radix_select(
        x.data_ptr(), n, k, tiles, ws.data_ptr(), cnt.data_ptr(), off.data_ptr(),
        pos.data_ptr(), keys.data_ptr(), _build.stream_of(x))
    _build.check(rc, "radix_select")
    _build.count_launch(radix_select, x, pos, keys)
    return pos, keys


radix_select.launches = 0


def order_winners(pos, keys):
    """The winners largest key first, equal keys in index order: a stable
    sort of the negated keys (the keys equal to t are the smallest and
    already in index order, so they stay last)."""
    return pos[torch.sort(-keys, stable=True).indices]


def radix_topk(x, k: int):
    """Positions (int64) of the k largest |x| of a 1-D f32 tensor, largest
    first, equal magnitudes in index order: ``lax.top_k``'s answer."""
    if k == 0:
        return torch.empty((0,), dtype=torch.int64, device=x.device)
    return order_winners(*radix_select(x, k))


def radix_topk_plain(x, k: int):
    """``radix_topk`` through the plain version on any device, k >= 1."""
    return order_winners(*radix_select_plain(x, k))
