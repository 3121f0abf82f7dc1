"""Plain selections Ω over a flat f32 vector, written from their definitions.

Two selection rules are measured:

* ``hist`` (the port's ``pallas`` Ω): the threshold is the largest of 64
  linear edges over [0, max|x|] (each at least the smallest normal f32)
  whose tail count |x| >= edge is at least k = keep_count(n, φ); 0 when x
  is all zero.  The flat sync sends the first k entries at or above it in
  index order (the first k positions if fewer pass); the DGC step and the
  faithful engine's hops keep every entry at or above it.
* ``topk`` (the port's ``fused`` Ω, exact): the k entries of largest |x|,
  equal magnitudes taken in index order.

Everything works in chunks so that a vector of 1.18e9 entries needs only a
few temporaries of its own size.
"""
from __future__ import annotations

import torch

TINY = float(torch.finfo(torch.float32).tiny)
BINS = 64
CHUNK = 1 << 26


def keep_count(size: int, phi: float) -> int:
    """Entries sent for sparsity φ: round((1 - φ)·size), at least one."""
    return max(1, int(round((1.0 - phi) * size)))


def hist_threshold(x: torch.Tensor, k: int, bins: int = BINS) -> torch.Tensor:
    """0-d f32: the largest linear edge whose tail count is >= k (exact int64
    counts); the first edge if none is; 0 when max|x| is 0."""
    x = x.reshape(-1)
    hi = torch.zeros((), dtype=torch.float32, device=x.device)
    for s in range(0, x.numel(), CHUNK):
        hi = torch.maximum(hi, x[s:s + CHUNK].abs().max())
    if float(hi) == 0.0:
        return hi
    edges = (torch.arange(bins, dtype=torch.float32, device=x.device) / bins) * hi
    edges = edges.clamp_min(TINY)
    hist = torch.zeros(bins + 1, dtype=torch.int64, device=x.device)
    for s in range(0, x.numel(), CHUNK):
        # the number of edges at or below each |x|
        pos = torch.searchsorted(edges, x[s:s + CHUNK].abs(), right=True)
        hist += torch.bincount(pos, minlength=bins + 1)
    tail = hist.flip(0).cumsum(0).flip(0)[1:]  # tail[b] = #{|x| >= edges[b]}
    idx = max(int((tail >= k).sum()) - 1, 0)
    return edges[idx]


def first_true(mask: torch.Tensor, k: int) -> torch.Tensor:
    """int64 positions of the first k True entries of a 1-D mask."""
    out, got = [], 0
    for s in range(0, mask.numel(), CHUNK):
        if got >= k:
            break
        p = mask[s:s + CHUNK].nonzero().squeeze(1)[:k - got] + s
        out.append(p)
        got += p.numel()
    return torch.cat(out) if out else torch.zeros(0, dtype=torch.int64,
                                                   device=mask.device)


def select_hist(x: torch.Tensor, phi: float) -> torch.Tensor:
    """Positions the flat sync sends under the ``hist`` rule."""
    x = x.reshape(-1)
    k = keep_count(x.numel(), phi)
    t = max(float(hist_threshold(x, k)), TINY)
    mask = x.abs() >= t
    if int(mask.sum()) < k:
        mask[:k] = True
    return first_true(mask, k)


def select_topk(x: torch.Tensor, phi: float) -> torch.Tensor:
    """Positions of the exact top-k of |x|, equal magnitudes in index order.
    The k-th largest magnitude is found by bisection on the f32 bit pattern
    (non-negative floats order as their bits), 31 counting passes."""
    x = x.reshape(-1)
    k = keep_count(x.numel(), phi)
    keys = x.abs().view(torch.int32)

    def count_ge(t: int) -> int:
        return sum(int((keys[s:s + CHUNK] >= t).sum())
                   for s in range(0, keys.numel(), CHUNK))

    lo, hi = 0, 0x7F800001  # count_ge(lo) >= k > count_ge(hi)
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if count_ge(mid) >= k:
            lo = mid
        else:
            hi = mid
    above = (keys > lo).nonzero().squeeze(1)
    ties = first_true(keys == lo, k - above.numel())
    return torch.cat([above, ties])


SELECT = {"hist": select_hist, "topk": select_topk}
# the rule each of the port's ``omega_impl`` names selects by
RULE_OF_IMPL = {"pallas": "hist", "hist": "hist", "topk": "topk", "fused": "topk"}


def sparse_hop(x: torch.Tensor, phi: float, rule: str):
    """(sent, residual) of one flat-sync payload: x restricted to the selected
    positions, and x with them removed."""
    pos = SELECT[rule](x, phi)
    sent = torch.zeros_like(x)
    sent[pos] = x[pos]
    return sent, x - sent


def omega_keep(v: torch.Tensor, phi: float) -> torch.Tensor:
    """Mask of the faithful engine's Ω under the ``hist`` rule: every entry at
    or above the threshold (all of them when v is all zero)."""
    th = hist_threshold(v, keep_count(v.numel(), phi))
    return v.abs() >= th
