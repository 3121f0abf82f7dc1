"""The port's copy of ``repro.wireless.qam`` (numpy only, bit-identical).

Uplink rate model (paper §II-A): truncated channel inversion + M-QAM.

Rayleigh fading: channel power gain γ ~ Exp(1), so P(γ >= th) = e^{-th} and
the truncated inverse mean  E[1/γ]_th = ∫_th^∞ e^{-γ}/γ dγ = E1(th).

Per-subcarrier expected rate (paper eq. 11), for an MU at distance d with
m assigned subcarriers (power split across them, eq. 4):

    Ū(th) = B0 log2(1 + 1.5 ρ(th) / (-ln(5 BER))) · e^{-th}
    ρ(th) = Pmax / (m · N0 B0 d^α · E1(th))

The threshold th is optimised by golden-section search (unimodal in th).
"""
from __future__ import annotations

from typing import Optional

import numpy as np


def exp_integral_e1(x: np.ndarray) -> np.ndarray:
    """E1(x) = ∫_x^∞ e^-t / t dt, vectorised (Allen–Hastings approximations)."""
    x = np.asarray(x, dtype=np.float64)
    out = np.empty_like(x)
    small = x <= 1.0
    xs = np.where(small, np.maximum(x, 1e-300), 1.0)
    # |err| < 2e-7 for 0 < x <= 1
    a = (-0.57721566, 0.99999193, -0.24991055, 0.05519968, -0.00976004, 0.00107857)
    poly = a[0] + xs * (a[1] + xs * (a[2] + xs * (a[3] + xs * (a[4] + xs * a[5]))))
    e1_small = poly - np.log(xs)
    xl = np.where(~small, x, 1.0)
    # |err| < 2e-8 for x >= 1
    num = xl * xl + 2.334733 * xl + 0.250621
    den = xl * xl + 3.330657 * xl + 1.681534
    e1_large = np.exp(-xl) / xl * (num / den)
    out = np.where(small, e1_small, e1_large)
    return out


def _rate_at_threshold(th, *, B0, Pmax, m, N0, d, alpha, ber):
    th = np.maximum(th, 1e-12)
    rho = Pmax / (m * N0 * B0 * (d ** alpha) * exp_integral_e1(th))
    snr_eff = 1.5 * rho / (-np.log(5.0 * ber))
    return B0 * np.log2(1.0 + snr_eff) * np.exp(-th)


def optimal_rate_vec(
    d, *, B0: float, Pmax: float, m: int, N0: float, alpha: float, ber: float,
    iters: int = 60, chunk: Optional[int] = None,
) -> np.ndarray:
    """Vectorised ``optimal_rate_per_subcarrier`` over a distance array.

    Golden-section search with per-element brackets; used by the simulator's
    million-MU pricing scale-out, where a Python loop over users would
    dominate. ~1e-7 relative agreement with the scalar path.

    ``chunk``: stream the search in pieces of at most this many lanes so a
    fleet-sized call keeps its ~10 working arrays cache-resident instead of
    allocating them all at fleet length (the engine's "streamed pricing").
    Chunking is bit-exact: each lane's bracket never reads its neighbours.
    """
    d = np.asarray(d, dtype=np.float64)
    if chunk is not None and d.ndim == 1 and len(d) > chunk:
        out = np.empty_like(d)
        for start in range(0, len(d), chunk):
            out[start:start + chunk] = optimal_rate_vec(
                d[start:start + chunk], B0=B0, Pmax=Pmax, m=m, N0=N0,
                alpha=alpha, ber=ber, iters=iters)
        return out
    gr = (np.sqrt(5.0) - 1.0) / 2.0
    lo = np.full(d.shape, 1e-6)
    hi = np.full(d.shape, 10.0)
    kw = dict(B0=B0, Pmax=Pmax, m=m, N0=N0, d=d, alpha=alpha, ber=ber)
    c = hi - gr * (hi - lo)
    dd = lo + gr * (hi - lo)
    fa = _rate_at_threshold(c, **kw)
    fb = _rate_at_threshold(dd, **kw)
    for _ in range(iters):
        take = fa > fb  # shrink from the right where the left probe wins
        hi = np.where(take, dd, hi)
        lo = np.where(take, lo, c)
        # per lane only ONE probe is new (the survivor slides over), so a
        # single vector evaluation per iteration suffices
        x_new = np.where(take, hi - gr * (hi - lo), lo + gr * (hi - lo))
        f_new = _rate_at_threshold(x_new, **kw)
        c, dd, fa, fb = (
            np.where(take, x_new, dd),
            np.where(take, c, x_new),
            np.where(take, f_new, fb),
            np.where(take, fa, f_new),
        )
    return np.maximum(fa, fb)


def optimal_rate_per_subcarrier(
    *, B0: float, Pmax: float, m: int, N0: float, d: float, alpha: float, ber: float,
    iters: int = 80,
) -> float:
    """max_th Ū(th) via golden-section search on th in (0, 10]."""
    gr = (np.sqrt(5.0) - 1.0) / 2.0
    lo, hi = 1e-6, 10.0
    c = hi - gr * (hi - lo)
    dd = lo + gr * (hi - lo)
    fa = _rate_at_threshold(c, B0=B0, Pmax=Pmax, m=m, N0=N0, d=d, alpha=alpha, ber=ber)
    fb = _rate_at_threshold(dd, B0=B0, Pmax=Pmax, m=m, N0=N0, d=d, alpha=alpha, ber=ber)
    for _ in range(iters):
        if fa > fb:
            hi, dd, fb = dd, c, fa
            c = hi - gr * (hi - lo)
            fa = _rate_at_threshold(c, B0=B0, Pmax=Pmax, m=m, N0=N0, d=d, alpha=alpha, ber=ber)
        else:
            lo, c, fa = c, dd, fb
            dd = lo + gr * (hi - lo)
            fb = _rate_at_threshold(dd, B0=B0, Pmax=Pmax, m=m, N0=N0, d=d, alpha=alpha, ber=ber)
    return float(max(fa, fb))
