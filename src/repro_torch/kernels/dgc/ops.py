"""Tiling and threshold glue around the DGC kernels (``repro.kernels.dgc.ops``).

Every entry pads the flat vector to (256 x 1024) tiles, runs
``update_max`` for the tile maxima, ``tail_hist`` against 64 linear edges
and ``pick_threshold`` (``_threshold``), with the reference's all-zero
rule: th = 0 when max|v| = 0, i.e. keep everything (all zeros, a no-op).

  * ``threshold_pallas``: the selection glue of ``sparsify.pack_phi(impl=
    "pallas")``: ``update_max`` with u = g = 0 and σ = 0 (``_abs_pass``).
  * ``omega_pallas``: Ω(x, φ) of ``sparsify.omega(impl="pallas")``: the
    same threshold, then ``apply_mask`` with a zero buffer as u.
  * ``dgc_step_pallas``: Alg. 4 lines 6-12 through the three kernels.

The kernels' CPU path is their plain version.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.sparsify import keep_count, linear_edges
from repro_torch.kernels.dgc import kernel as K
from repro_torch.kernels.dgc import ref

_BLOCK_ELEMS = K.BLOCK_ROWS * K.BLOCK_COLS
_TINY = float(np.finfo(np.float32).tiny)


def _to_tiles(x):
    n = x.numel()
    pad = (-n) % _BLOCK_ELEMS
    xf = F.pad(x.reshape(-1).float(), (0, pad))
    return xf.reshape(-1, K.BLOCK_COLS), n, pad


def _from_tiles(t, n, shape, dtype):
    return t.reshape(-1)[:n].reshape(shape).to(dtype)


def _threshold(v2, bmax, n: int, phi: float, bins: int):
    """0-d f32 threshold from ``update_max``'s tile maxima and output:
    ``tail_hist`` -> ``pick_threshold``, 0 on an all-zero vector."""
    hi = bmax.max()
    edges = linear_edges(hi, bins).clamp_min(_TINY)
    counts = K.tail_hist(v2, edges)
    th = ref.pick_threshold(counts, edges, keep_count(n, phi))
    return torch.where(hi > 0.0, th, torch.zeros_like(th))


def _abs_pass(x):
    """``update_max`` with u = g = 0 and σ = 0 (one zero tile buffer as
    both, as in the reference): (x as tiles, tile maxima of |x|, n)."""
    xt, n, _ = _to_tiles(x)
    zero = torch.zeros_like(xt)
    v2, bmax = K.update_max(zero, xt, zero, 0.0)[1:]
    return v2, bmax, n


def threshold_pallas(x, phi: float, *, bins: int = 64):
    """|x| threshold keeping >= keep_count(n, φ) entries via the DGC passes;
    a 0-d f32 tensor (0.0 on an all-zero input, i.e. keep everything)."""
    v2, bmax, n = _abs_pass(x)
    return _threshold(v2, bmax, n, phi, bins)


def omega_pallas(x, phi: float, *, bins: int = 64):
    """Ω(x, φ) via the three DGC passes: (sparse x in x's shape and dtype,
    mask). The mask compares |x| with th in f32 whatever x's dtype, as jnp
    promotes a bf16 x against the f32 threshold."""
    v2, bmax, n = _abs_pass(x)
    th = _threshold(v2, bmax, n, phi, bins)
    ghat = K.apply_mask(torch.zeros_like(v2), v2, th)[0]
    return (_from_tiles(ghat, x.numel(), x.shape, x.dtype),
            (x.abs().float() >= th).reshape(x.shape))


def dgc_step_pallas(u, v, g, sigma: float, phi: float, *, bins: int = 64):
    """Alg. 4 lines 6-12 via the three DGC passes: (ĝ, u'', v'') in v's
    shape and dtype; the contract of ``sparsify.dgc_step`` with a hist
    threshold."""
    shape, dtype = v.shape, v.dtype
    ut, n, _ = _to_tiles(u)
    vt, _, _ = _to_tiles(v)
    gt, _, _ = _to_tiles(g)
    u2, v2, bmax = K.update_max(ut, vt, gt, sigma)
    del ut, vt, gt
    th = _threshold(v2, bmax, n, phi, bins)
    return tuple(_from_tiles(t, n, shape, dtype) for t in K.apply_mask(u2, v2, th))
