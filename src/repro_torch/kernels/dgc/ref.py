"""Threshold pick shared by the DGC passes (``repro.kernels.dgc.ref``)."""
from __future__ import annotations

import numpy as np


def pick_threshold(counts, edges, k):
    """Largest edge whose tail count >= k (guarantees >= k kept). ``k`` is
    compared as float32, as jnp compares a Python int with f32 counts."""
    ok = counts >= float(np.float32(k))
    idx = (ok.sum() - 1).clamp_min(0)
    return edges[idx]
