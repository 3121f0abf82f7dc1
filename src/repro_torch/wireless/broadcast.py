"""The port's copy of ``repro.wireless.broadcast`` (numpy only,
bit-identical).

Downlink broadcast latency (paper §II-B, eq. 16-18).

The base station broadcasts with a rateless code adapted per OFDM symbol to
the worst instantaneous SNR on each sub-carrier; power is split uniformly.
Monte-Carlo over Rayleigh channel draws.
"""
from __future__ import annotations

import numpy as np


def broadcast_latency(
    distances,
    payload_bits: float,
    *,
    M: int,
    B0: float,
    Pmax: float,
    N0: float,
    alpha: float,
    Ts: float = 1e-3,
    rng=None,
    max_symbols: int = 200000,
    trials: int = 8,
) -> float:
    """Expected time (s) until every MU has ``payload_bits``."""
    rng = rng or np.random.default_rng(0)
    d = np.asarray(distances, dtype=np.float64)
    K = len(d)
    if payload_bits <= 0:
        return 0.0
    snr_scale = Pmax / (M * N0 * B0 * d ** alpha)  # [K]
    ts = []
    for _ in range(trials):
        acc = 0.0
        # vectorised over blocks of symbols for speed
        t = 0
        while t < max_symbols:
            blk = 256
            gam = rng.exponential(1.0, size=(blk, K, M))
            snr = gam * snr_scale[None, :, None]
            rate = B0 * np.log2(1.0 + snr).min(axis=1).sum(axis=1)  # [blk] worst-MU
            cum = acc + np.cumsum(rate * Ts)
            hit = np.nonzero(cum >= payload_bits)[0]
            if hit.size:
                ts.append((t + hit[0] + 1) * Ts)
                break
            acc = cum[-1]
            t += blk
        else:
            ts.append(max_symbols * Ts)
    return float(np.mean(ts))
