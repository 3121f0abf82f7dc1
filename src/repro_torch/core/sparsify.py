"""Model-difference sparsification Ω (paper §IV; DGC, Lin et al. 2018).

The port of ``repro.core.sparsify``: the payload functions of the flat
sync and the per-vector ``omega``/``dgc_step`` of the paper-exact engine.
Every selection is bit-identical to the reference's, ties included: ``lax.top_k`` puts the
lower index first among equal magnitudes, and ``torch.topk`` promises no
tie order, so exact top-k here is ``stable_topk_positions`` — a radix
select of the k-th largest |x| key followed by a stable sort of the k
winners, which returns exactly the first k of a stable descending argsort
while sorting only k entries (the whole-vector sort of a full-size model
would not fit beside its state). On CUDA the select runs as the
hand-written kernels of ``kernels/radix_select``, on the CPU as torch ops.

``impl`` of ``pack_phi`` and ``omega``:
  * ``topk``   -- exact top-k (reference)
  * ``hist``   -- histogram threshold + O(Q) compaction
  * ``pallas`` -- threshold from the DGC kernels (``kernels/dgc``) +
                  O(Q) compaction
  * ``fused``  -- the fused threshold/compaction kernel
                  (``kernels/fused_sync``), selection bit-identical to topk
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.radix_select import kernel as _rs
from repro_torch.obs.metrics import current_registry
from repro_torch.obs.spans import span
from repro_torch.utils.fp import fma_f32

_TINY = float(np.finfo(np.float32).tiny)
_CHUNK = 1 << 26  # elements per pass of the chunked scans below


def keep_count(size: int, phi: float) -> int:
    """Number of entries transmitted for sparsity parameter φ."""
    return max(1, int(round((1.0 - phi) * size)))


# ---------------------------------------------------------------------------
# Exact stable top-k
# ---------------------------------------------------------------------------


def _kth_key(keys, k: int):
    """Radix select over 31-bit keys, 11/10/10 bits from the top:
    (t, need) with t the k-th largest key and ``need`` the number of keys
    equal to t inside the top k."""
    prefix, cand = 0, keys
    for shift, width in ((20, 11), (10, 10), (0, 10)):
        digit = (cand >> shift) & ((1 << width) - 1)
        hist = torch.bincount(digit, minlength=1 << width)
        ge = hist.flip(0).cumsum(0).flip(0)  # #digits >= d
        with span("wait.topk"):  # the digit, the count and the survivors' size
            d = int((ge >= k).nonzero().max())
            k -= int(ge[d] - hist[d])  # keys with a larger digit are all in
            prefix |= d << shift
            cand = cand[digit == d]
    return prefix, k


def first_true(mask, k: int):
    """int64 positions of the first ``k`` True entries of a 1-D mask, in
    index order (fewer if it holds fewer), scanned in chunks so the index
    list never grows past k."""
    out, got = [], 0
    for start in range(0, mask.numel(), _CHUNK):
        if got >= k:
            break
        with span("wait.first_true"):  # nonzero reads its count
            p = mask[start:start + _CHUNK].nonzero().squeeze(1)[:k - got] + start
        out.append(p)
        got += p.numel()
    if not out:
        return torch.zeros((0,), dtype=torch.int64, device=mask.device)
    return torch.cat(out)


def stable_topk_positions(x, k: int):
    """Positions of the k largest |x| of a 1-D f32 tensor, largest first,
    equal magnitudes in index order: the first k of a stable descending
    argsort of |x|, i.e. ``lax.top_k``'s answer. Each row ranked counts
    once in ``sparsify.exact_topk_rows{route}`` of the ambient registry:
    ``kernel`` on CUDA (``kernels/radix_select``, no device->host read),
    ``plain`` elsewhere (``_stable_topk_torch``)."""
    k = min(k, x.numel())
    if x.device.type == "meta":  # no values to rank: the positions' shape
        return torch.empty((k,), dtype=torch.int64, device=x.device)
    rows = current_registry().counter("sparsify.exact_topk_rows")
    if x.device.type == "cuda":
        rows.inc(route="kernel")
        return _rs.radix_topk(x.reshape(-1).contiguous(), k)
    rows.inc(route="plain")
    return _stable_topk_torch(x, k)


def _stable_topk_torch(x, k: int):
    """``stable_topk_positions`` in torch ops (the plain route), on any
    device, 0 <= k <= numel."""
    keys = _rs.abs_keys(x.reshape(-1))
    with span("wait.topk"):
        nnz = int(torch.count_nonzero(keys))
    if nnz <= k:  # all nonzeros are in, then the first zeros: t = 0
        t, need = 0, k - nnz
    else:
        t, need = _kth_key(keys, k)
    with span("wait.topk"):
        gt = (keys > t).nonzero().squeeze(1)
    order = torch.sort(-keys[gt], stable=True).indices
    return torch.cat([gt[order], first_true(keys == t, need)])


# ---------------------------------------------------------------------------
# Thresholds and masks
# ---------------------------------------------------------------------------


def linear_edges(hi, bins: int):
    """``jnp.linspace(0, 1, bins + 1)[:-1] * hi`` in f32: jnp computes the
    base as iota / bins, which is what ``arange / bins`` gives."""
    base = torch.arange(bins, dtype=torch.float32, device=hi.device) / bins
    return base * hi


def threshold_for_phi(x, phi: float, *, bins: int = 64):
    """Histogram estimate of the |x| threshold keeping >= k = keep_count
    entries: the largest linear edge over [0, max|x|] whose tail count is
    >= k (one sort + one searchsorted, as in the reference)."""
    a = x.abs().reshape(-1).float()
    k = keep_count(a.numel(), phi)
    edges = linear_edges(a.max(), bins)
    a_sorted = torch.sort(a).values
    counts = a.numel() - torch.searchsorted(a_sorted, edges, side="left")
    idx = (counts >= k).sum() - 1
    return edges[idx.clamp_min(0)]


def mask_at_least_k(x, th, k: int):
    """Mask of ``|x| >= max(th, tiny)``, padded with the first positions to
    honour the ">= k kept" contract when fewer entries survive the floor.
    The reference's ``jnp.where`` on the count is a host branch here.
    |x| is compared in f32 whatever x's dtype, as jnp promotes a bf16
    array against the f32 threshold (torch would round the 0-d threshold
    to bf16 instead)."""
    t = torch.clamp_min(torch.as_tensor(th, dtype=torch.float32,
                                        device=x.device), _TINY)
    base = x.abs().float() >= t
    with span("wait.mask_count"):
        short = int(base.sum()) < k
    if short:
        base.reshape(-1)[:k] = True
    return base


def threshold_mask(x, phi: float, *, bins: int = 64):
    th = threshold_for_phi(x, phi, bins=bins)
    return mask_at_least_k(x, th, keep_count(x.numel(), phi))


def topk_mask(x, k: int):
    """Boolean mask of the k largest-|x| entries, ties to the lower index
    (``lax.top_k``'s order). x any shape."""
    flat = x.reshape(-1).float()
    mask = torch.zeros(flat.shape, dtype=torch.bool, device=x.device)
    mask[stable_topk_positions(flat, k)] = True
    return mask.reshape(x.shape)


# ---------------------------------------------------------------------------
# Ω and the DGC step (the paper-exact engine's per-vector selections)
# ---------------------------------------------------------------------------


def omega(v, phi: float, *, impl: str = "topk"):
    """Ω(V, φ): (sparse v, mask). φ <= 0 returns v itself and an all-True
    mask. The reference's ``v * mask`` is, as XLA compiles it, a select:
    masked-out entries are +0.0 whatever v's sign."""
    if phi <= 0.0:
        return v, torch.ones(v.shape, dtype=torch.bool, device=v.device)
    if impl == "topk":
        mask = topk_mask(v, keep_count(v.numel(), phi))
    elif impl == "hist":
        mask = threshold_mask(v, phi)
    elif impl == "pallas":
        from repro_torch.kernels.dgc import ops as _k

        return _k.omega_pallas(v, phi)
    elif impl == "fused":
        from repro_torch.kernels.fused_sync import ops as _f

        _, idx = _f.fused_pack_phi(v, phi)
        mask = torch.zeros((v.numel(),), dtype=torch.bool, device=v.device)
        mask[idx.long()] = True
        mask = mask.reshape(v.shape)
    else:
        raise ValueError(impl)
    return torch.where(mask, v, 0.0), mask


def dgc_step(u, v, g, sigma: float, phi: float, *, impl: str = "topk"):
    """One MU-side sparse-momentum step (Alg. 4 lines 6-12):

        u <- σ·u + g   (one fused multiply-add, as XLA compiles it)
        v <- v + u
        ĝ  = Ω(v, φ);  u <- u ⊙ ¬mask;  v <- v ⊙ ¬mask

    The masking products are selects, as XLA compiles them (+0.0 where
    the mask holds). Returns (ĝ, u', v')."""
    u = fma_f32(sigma, u, g).to(u.dtype)
    v = v + u
    ghat, mask = omega(v, phi, impl=impl)
    return ghat, torch.where(mask, 0.0, u), torch.where(mask, 0.0, v)


# ---------------------------------------------------------------------------
# Sparse exchange payloads (values + indices)
# ---------------------------------------------------------------------------


def pack_topk(x, k: int):
    """-> (values [k], indices [k] int32) of the k largest-|x| entries."""
    flat = x.reshape(-1)
    pos = stable_topk_positions(flat, k)
    return flat[pos], pos.to(torch.int32)


def unpack_topk(values, indices, size: int, shape=None):
    out = torch.zeros((size,), dtype=values.dtype, device=values.device)
    out.index_add_(0, indices.long(), values)
    return out.reshape(shape) if shape is not None else out


def compact_mask(x, mask, k: int):
    """Fixed-size (values [k], indices [k] int32) payload of the masked
    entries without a top-k: the first k in index order (surplus
    truncated); spare slots hold (0, 0), a scatter-add no-op. The
    reference's scatter with slot k as the out-of-range "drop" slot has
    no counterpart: only the first k positions are ever gathered."""
    flat = x.reshape(-1)
    pos = first_true(mask.reshape(-1), k)
    vals = torch.zeros((k,), dtype=flat.dtype, device=flat.device)
    idx = torch.zeros((k,), dtype=torch.int32, device=flat.device)
    vals[:pos.numel()] = flat[pos]
    idx[:pos.numel()] = pos.to(torch.int32)
    return vals, idx


def pack_phi(x, phi: float, *, impl: str = "topk", bins: int = 64):
    """Fixed-size sparse payload of Ω(x, φ): (values [k], indices [k])."""
    flat = x.reshape(-1)
    k = keep_count(flat.numel(), phi)
    if impl == "topk":
        return pack_topk(flat, k)
    if impl == "fused":
        from repro_torch.kernels.fused_sync import ops as _f

        return _f.fused_pack_phi(flat, phi, bins=bins)
    if impl == "hist":
        mask = threshold_mask(flat, phi, bins=bins)
    elif impl == "pallas":
        from repro_torch.kernels.dgc import ops as _k

        th = _k.threshold_pallas(flat, phi, bins=bins)
        mask = mask_at_least_k(flat, th, k)
    else:
        raise ValueError(impl)
    return compact_mask(flat, mask, k)
