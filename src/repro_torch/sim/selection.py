"""The port's copy of ``repro.sim.selection`` (numpy only, the same
selector RNG stream).

Client-selection policies: which available MUs actually train a round.

First-class engine hook (``SimEngine.selector``): after the availability
draw (and fault injection) of each round, the selector caps every
cluster's participants at ``ceil(prate * cluster_size)`` and picks WHICH
members fill the cap under a policy:

  * ``uniform`` — unbiased: a uniform draw from the cluster's available
    members (the selector's OWN ``np.random`` stream, so turning selection
    on never perturbs the fleet's availability/mobility RNG trajectories).
  * ``biased``  — rate-biased: the fastest devices first (lowest compute
    multiplier, stable id tie-break) — the Pareto-style selection that
    trades straggler time and uplink traffic for a skewed data mix.
  * ``kmeans``  — location-based: k-means over the cluster's member
    positions with k = the cap, keeping the medoid of each centroid, so
    the participants stay spatially representative of the cell.

``prate >= 1`` with the ``uniform`` policy is the identity — the engine
builds no selector at all (``make_selector`` returns None), keeping every
existing scenario's RNG and masks bit-identical.

Participation flows downstream for free: the engine's ``_round_ctx`` mask
shrinks, dropped members' batch rows are resampled from the selected
survivors (``_apply_participation``), and ``_count_train`` charges the
access uplink per *participant* — so a ``prate`` cut shows up directly in
``bits_access_total`` under both accounting modes.
"""
from __future__ import annotations

import math

import numpy as np

_POLICIES = ("uniform", "biased", "kmeans")


def _kmeans_medoids(pos: np.ndarray, k: int, rng, iters: int = 8):
    """Indices (into ``pos``) of the medoids of a k-means clustering."""
    m = pos.shape[0]
    ctr = pos[rng.choice(m, size=k, replace=False)].astype(np.float64)
    for _ in range(iters):
        d = ((pos[:, None, :] - ctr[None]) ** 2).sum(-1)
        lab = d.argmin(axis=1)
        for j in range(k):
            sel = lab == j
            if sel.any():
                ctr[j] = pos[sel].mean(axis=0)
    d = ((pos[:, None, :] - ctr[None]) ** 2).sum(-1)
    picks, used = [], np.zeros(m, bool)
    for j in range(k):
        for i in np.argsort(d[:, j], kind="stable"):
            if not used[i]:
                used[i] = True
                picks.append(int(i))
                break
    return np.asarray(picks, np.int64)


class ClientSelector:
    """Per-round participation filter: ``select(avail, fleet, t)`` returns
    the selected subset of ``avail`` (bool [K]).

    ``select(..., clusters=...)`` restricts the policy to a subset of
    clusters — the per-tier hook: a mixed-discipline run selects per unit
    (the clusters under one asynchronously-scheduled aggregator) at that
    unit's own round times instead of fleet-wide at a global barrier.
    ``clusters=None`` (the default) keeps the historical fleet-wide sweep
    and its RNG draw order bit-identical."""

    def __init__(self, hfl_cfg, sim_cfg):
        self.prate = float(getattr(sim_cfg, "prate", 1.0))
        self.policy = getattr(sim_cfg, "selection", "uniform")
        if self.policy not in _POLICIES:
            raise ValueError(
                f"unknown selection policy {self.policy!r}; "
                f"expected one of {_POLICIES}")
        if not 0.0 < self.prate <= 1.0:
            raise ValueError(f"prate must be in (0, 1], got {self.prate}")
        self.hfl = hfl_cfg
        # own stream: selection must not perturb the fleet RNG trajectory
        self._rng = np.random.default_rng(
            0x5E1EC7 ^ int(getattr(sim_cfg, "seed", 0)))

    def cap(self, cluster_size: int) -> int:
        return max(1, math.ceil(self.prate * cluster_size))

    def select(self, avail, fleet, t: float, clusters=None) -> np.ndarray:
        if avail is None:
            avail = np.ones(fleet.K, bool)
        out = np.zeros(fleet.K, bool)
        comp = fleet.compute_mult
        # the fleet's cached CSR membership view: one stable argsort per
        # (re)association epoch instead of N nonzero scans per round
        order, starts = fleet.cluster_members_csr()
        if clusters is None:
            clusters = range(self.hfl.num_clusters)
        for n in clusters:
            members = order[starts[n]:starts[n + 1]]
            if members.size == 0:
                continue
            cand = members[avail[members]]
            cap = self.cap(members.size)
            if cand.size <= cap:
                out[cand] = True
                continue
            if self.policy == "uniform":
                pick = self._rng.choice(cand, size=cap, replace=False)
            elif self.policy == "biased":
                pick = cand[np.argsort(comp[cand], kind="stable")[:cap]]
            else:  # kmeans
                pick = cand[_kmeans_medoids(
                    np.asarray(fleet.pos)[cand], cap, self._rng)]
            out[pick] = True
        return out


def make_selector(hfl_cfg, sim_cfg):
    """None when selection is the identity (prate >= 1, uniform policy) —
    the engine then skips the hook entirely, bit-identically."""
    if hfl_cfg is None or sim_cfg is None:
        return None
    prate = float(getattr(sim_cfg, "prate", 1.0))
    policy = getattr(sim_cfg, "selection", "uniform")
    if prate >= 1.0 and policy == "uniform":
        return None
    return ClientSelector(hfl_cfg, sim_cfg)
