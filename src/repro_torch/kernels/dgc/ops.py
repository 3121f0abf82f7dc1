"""Tiling and threshold glue around the DGC kernels (``repro.kernels.dgc.ops``).

``threshold_pallas`` is the selection glue of ``sparsify.pack_phi(impl=
"pallas")``: pad the flat vector to (256 x 1024) tiles, run ``update_max``
with u = g = 0 and σ = 0 (one zero tile buffer serves as both, as in the
reference) for the tile maxima, ``tail_hist`` against 64 linear edges,
then ``pick_threshold``. The kernels' CPU path is their plain version.
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


def threshold_pallas(x, phi: float, *, bins: int = 64):
    """|x| threshold keeping >= keep_count(n, φ) entries via the DGC passes;
    a 0-d f32 tensor (0.0 on an all-zero input, i.e. keep everything)."""
    xt, n, _ = _to_tiles(x)
    zero = torch.zeros_like(xt)
    v2, bmax = K.update_max(zero, xt, zero, 0.0)[1:]
    del xt, zero  # the sync runs at full model size: free before the next pass
    hi = bmax.max()
    edges = linear_edges(hi, bins).clamp_min(_TINY)
    counts = K.tail_hist(v2, edges)
    th = ref.pick_threshold(counts, edges, keep_count(n, phi))
    return torch.where(hi > 0.0, th, torch.zeros_like(th))
