"""The port's copy of ``repro.wireless.subcarrier`` (numpy only,
bit-identical).

Algorithm 2: optimal max-min sub-carrier allocation.

Greedy water-filling over users: start with one sub-carrier each, repeatedly
give one more to the currently-slowest MU (re-optimising its threshold).
Theorem 1 proves this max-min optimal; tests cross-check against brute force
on small instances.
"""
from __future__ import annotations

import numpy as np

from repro_torch.wireless.qam import optimal_rate_per_subcarrier


def user_rate(m: int, d: float, *, B0, Pmax, N0, alpha, ber) -> float:
    """Total expected UL rate of an MU with m sub-carriers at distance d."""
    if m <= 0:
        return 0.0
    per = optimal_rate_per_subcarrier(
        B0=B0, Pmax=Pmax, m=m, N0=N0, d=d, alpha=alpha, ber=ber
    )
    return m * per


def allocate_subcarriers(distances, M: int, *, B0, Pmax, N0, alpha, ber):
    """-> (m_k array of per-MU sub-carrier counts, rates array)."""
    K = len(distances)
    assert M >= K, "need at least one sub-carrier per MU"
    m = np.ones(K, dtype=int)
    kw = dict(B0=B0, Pmax=Pmax, N0=N0, alpha=alpha, ber=ber)
    rates = np.array([user_rate(1, d, **kw) for d in distances])
    for _ in range(M - K):
        k_star = int(np.argmin(rates))
        m[k_star] += 1
        rates[k_star] = user_rate(m[k_star], distances[k_star], **kw)
    return m, rates


def min_rate(distances, M: int, **kw) -> float:
    _, rates = allocate_subcarriers(distances, M, **kw)
    return float(rates.min())


def reallocate_after_drop(distances, alive, M: int, *, B0, Pmax, N0, alpha, ber):
    """Re-run the max-min allocation over the SURVIVING MUs only.

    When the deadline discipline drops a straggler mid-round, its
    sub-carriers do not go dark: the scheduler re-runs Alg. 2 over the
    survivors with the full ``M`` budget, so the reclaimed bandwidth
    raises the survivors' (max-min) rates — every surviving rate is >= its
    pre-drop value, because the greedy allocation with fewer users can
    only give each user more sub-carriers.

    -> rates array aligned with ``distances`` (0.0 for dropped MUs).
    """
    distances = np.asarray(distances, float)
    alive = np.asarray(alive, bool)
    assert alive.shape == distances.shape
    rates = np.zeros(len(distances))
    if alive.any():
        _, r = allocate_subcarriers(
            distances[alive], M, B0=B0, Pmax=Pmax, N0=N0, alpha=alpha, ber=ber
        )
        rates[alive] = r
    return rates
