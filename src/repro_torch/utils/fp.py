"""Float32 arithmetic as the reference's compiled programs round it.

XLA compiles ``y + a*x`` into one fused multiply-add (a single rounding)
and ``x / N`` into ``x * (1/N)``; PyTorch's separate ops round each
product and sum. Where the two can differ, the port computes the
reference's form: ``fma_f32`` is a correctly rounded f32 fma built from
f64 operations, and ``axpy_`` takes the cheap two-op path whenever the
product is exact (a power-of-two multiplier), where both forms agree.
"""
from __future__ import annotations

import math

import numpy as np
import torch

_CHUNK = 1 << 24


def is_pow2(a: float) -> bool:
    """True for 0 and +-2^k: multiplying an f32 by it is exact."""
    return a == 0.0 or math.frexp(abs(a))[0] == 0.5


def recip_f32(n: int) -> float:
    """``1/n`` as the f32 constant XLA multiplies by for ``x / n``."""
    return float(np.float32(1.0) / np.float32(n))


def fma_f32(a: float, x, y):
    """a·x + y rounded ONCE to f32: the product is exact in f64, the f64
    sum is made round-to-odd with a TwoSum error term, and round-to-odd
    followed by round-to-nearest 29 bits lower is correctly rounded."""
    p = x.double() * float(np.float32(a))
    yd = y.double()
    r = p + yd
    bp = r - yd
    err = (p - (r - bp)) + (yd - bp)
    even = (r.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.full_like(r, np.inf),
                         torch.full_like(r, -np.inf))
    return torch.where((err != 0) & even, torch.nextafter(r, toward), r).float()


def axpy_(y, a: float, x):
    """y <- fma(a, x, y) in place, chunked so the f64 temporaries stay
    small; two plain ops when ``a`` is a power of two."""
    if is_pow2(a):
        return y.add_(x * a)
    yf, xf = y.view(-1), x.reshape(-1)
    for s in range(0, yf.numel(), _CHUNK):
        yf[s:s + _CHUNK] = fma_f32(a, xf[s:s + _CHUNK], yf[s:s + _CHUNK])
    return y
