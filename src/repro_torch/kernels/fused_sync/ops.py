"""Exact whole-vector top-k without a whole-vector sort (``repro.kernels.
fused_sync.ops``): threshold estimate on a strided sample, compaction of
the candidates ``|x| >= th``, an exact-k finisher over the candidates and
a guaranteed-exact fallback.

The reference's compiled branch (``interpret=False``) runs the compaction
through the ``block_select`` kernel; its default ``interpret=True``
branch, the one every reference caller took, compacts with cumsum +
searchsorted or, below k < n/24, makes one batched ``lax.top_k``. The port
follows the reference per device: on the CPU it takes the interpret
branches; on CUDA it always runs the kernel pipeline (threshold ->
``block_select`` -> finisher, exact fallback). Both give the same
selection, bit-identical to ``lax.top_k`` including ties.

The exactness check ``ok`` (a ``lax.cond`` in the reference) is a host
branch here, one device->host sync per row: rows are compacted (every
row, as the reference launches the kernel for every row), checked and
finished one at a time, so only one row's candidate buffer is alive at
full model size, and rows of a batch bound for the exact path are not
finished.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.sparsify import (
    first_true, keep_count, linear_edges, stable_topk_positions,
)
from repro_torch.kernels.fused_sync import kernel as K

_TINY = float(np.finfo(np.float32).tiny)
_BINS = 128
_SAMPLE = 16384
_MARGIN = 2
_PIPELINE_MIN_FRAC = 1 / 24


def candidate_capacity(n: int, k: int) -> int:
    """Static candidate-buffer size: k plus threshold overshoot headroom."""
    return int(min(n, k + k // 4 + max(n // 24, 128) + 2048))


def tile_capacity(n: int, cap: int) -> int:
    """Candidate slots per tile of ``BLOCK_ELEMS`` for a row of n entries
    and a candidate capacity ``cap``: the even share plus a quarter and 64."""
    per = -(-cap // -(-n // K.BLOCK_ELEMS))
    return min(K.BLOCK_ELEMS, per + per // 4 + 64)


def _row_threshold(S, k: int, *, bins: int, sample: int, margin: int):
    """|x| threshold per row of S [R, n] keeping >= k entries w.h.p.: tail
    counts of a strided sample against linear edges (the ``tail_hist``
    scheme), stepped ``margin`` bins down, floored at the tiny normal.
    Only the sample is ever made absolute."""
    n = S.shape[1]
    stride = max(1, n // sample)
    Sa = S[:, ::stride].abs()
    ns = Sa.shape[1]
    edges = linear_edges(Sa.amax(dim=1)[:, None], bins)  # [R, bins]
    counts = (Sa[:, None, :] >= edges.clamp_min(_TINY)[:, :, None]).sum(
        dim=2).float()
    ks = float(np.float32(k * (ns / n)))  # jnp compares the Python float as f32
    j = ((counts >= ks).sum(dim=1) - 1 - margin).clamp_min(0)
    th = edges.gather(1, j[:, None])[:, 0]
    return th.clamp_min(_TINY)


def _compact_plain(S, th, cap: int):
    """CPU compaction: each row's candidates in index order, the first
    ``cap`` of them, pads (0, n); the output of the reference's
    cumsum/searchsorted ``_compact_jnp``."""
    R, n = S.shape
    vals = torch.zeros((R, cap), dtype=torch.float32, device=S.device)
    idx = torch.full((R, cap), n, dtype=torch.int32, device=S.device)
    m = torch.zeros((R,), dtype=torch.int64, device=S.device)
    for r in range(R):
        mask = S[r].abs() >= th[r]
        m[r] = mask.sum()
        pos = first_true(mask, cap)
        vals[r, :pos.numel()] = S[r, pos]
        idx[r, :pos.numel()] = pos.to(torch.int32)
    return vals, idx, m, torch.zeros((R,), dtype=torch.bool, device=S.device)


def _compact_kernel(S, th, cap: int):
    """Compaction through ``block_select``: fixed per-tile candidate slots,
    no cross-tile offsets (pad slots lose to every real candidate). The
    tile capacity and the overflow predicate are the reference's."""
    R, n = S.shape
    cap_blk = tile_capacity(n, cap)
    vals_l, idx_l, m_l, of_l = [], [], [], []
    for r in range(R):
        v, i, c = K.block_select(S[r], th[r:r + 1], cap_blk, n)
        vals_l.append(v.reshape(-1))
        idx_l.append(i.reshape(-1))
        m_l.append(c.sum())
        of_l.append((c[:, 0] > cap_blk).any())
    return (torch.stack(vals_l), torch.stack(idx_l), torch.stack(m_l),
            torch.stack(of_l))


def _finish_topk(vals_c, idx_c, k: int):
    """Exact-k finisher: stable top-k over each row's candidates. They are
    in index order with (0, n) pads, so ties resolve as whole-vector
    ``lax.top_k`` would."""
    vals, idx = [], []
    for r in range(vals_c.shape[0]):
        pos = stable_topk_positions(vals_c[r], k)
        vals.append(vals_c[r, pos])
        idx.append(idx_c[r, pos])
    return torch.stack(vals), torch.stack(idx)


def _exact_sort_rows(S, k: int):
    """Stable exact top-k of every row (the guaranteed fallback and the
    k >= n path): the first k of a stable descending argsort of |x|."""
    vals, idx = [], []
    for r in range(S.shape[0]):
        pos = stable_topk_positions(S[r], k)
        vals.append(S[r, pos])
        idx.append(pos.to(torch.int32))
    return torch.stack(vals), torch.stack(idx)


def select_topk_rows(S, k: int, *, bins: int = _BINS, sample: int = _SAMPLE,
                     margin: int = _MARGIN, interpret=None):
    """Exact top-k of every row of S [R, n]: (vals [R, k], idx [R, k] int32),
    bit-identical to per-row ``lax.top_k(|S|, k)``.

    ``interpret`` picks the reference's branch: None follows the device
    (CPU -> True, CUDA -> False); False on a CPU tensor drives the
    block-compaction pipeline through the plain ``block_select``; True on
    a CUDA tensor is refused (the card runs the kernel pipeline).
    """
    R, n = S.shape
    S = S.float()
    if interpret is None:
        interpret = S.device.type == "cpu"
    if interpret and S.device.type != "cpu":
        raise ValueError("select_topk_rows: the interpret branch is the CPU "
                         "path; CUDA tensors run the block_select pipeline")
    if k >= n:
        return _exact_sort_rows(S, k)
    if interpret and k < _PIPELINE_MIN_FRAC * n:
        return _exact_sort_rows(S, k)  # the reference's batched lax.top_k
    cap = candidate_capacity(n, k)
    th = _row_threshold(S, k, bins=bins, sample=sample, margin=margin)
    compact = _compact_plain if interpret else _compact_kernel
    vals, idx, ok = [], [], True
    for r in range(R):  # one row's candidates alive at a time
        vals_c, idx_c, m, overflow = compact(S[r:r + 1], th[r:r + 1], cap)
        ok = ok and bool(((m >= k) & (m <= cap) & ~overflow).all())  # host sync
        if ok:  # a batch bound for the exact path is not finished first
            v, i = _finish_topk(vals_c, idx_c, k)
            vals.append(v)
            idx.append(i)
    select_topk_rows.outcomes.append(ok)
    if ok:
        select_topk_rows.finished += 1
        return torch.cat(vals), torch.cat(idx)
    # the reference's lax.cond: any row outside [k, cap] (or a tile that
    # overflowed) sends the whole batch to the exact path
    select_topk_rows.fallbacks += 1
    return _exact_sort_rows(S, k)


select_topk_rows.finished = 0   # calls answered from the candidates
select_topk_rows.fallbacks = 0  # calls that took the exact fallback
select_topk_rows.outcomes = []  # one bool per call, in order: candidates answered


def fused_pack_phi(x, phi: float, *, interpret=None, **kw):
    """Single-vector Ω payload via the fused path: (values [k], indices
    [k] int32), k = ``keep_count(n, phi)``."""
    flat = x.reshape(-1)
    k = keep_count(flat.numel(), phi)
    vals, idx = select_topk_rows(flat[None, :], k, interpret=interpret, **kw)
    return vals[0], idx[0]
