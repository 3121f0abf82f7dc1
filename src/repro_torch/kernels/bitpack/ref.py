"""NumPy reference for the bitmap bit-pack (``repro.kernels.bitpack.ref``)."""
from __future__ import annotations

import numpy as np


def bitpack_ref(mask: np.ndarray) -> np.ndarray:
    """Flat 0/1 mask -> LSB-first bitmap bytes (``ceil(n/8)`` uint8),
    exactly ``np.packbits(bitorder="little")`` -- the codec's host path."""
    bits = (np.asarray(mask).reshape(-1) != 0).astype(np.uint8)
    return np.packbits(bits, bitorder="little")
