"""The port's copy of ``repro.sim.devices`` (numpy only, the same RNG
stream and draw order, so a fleet replays bit-identically). Trace replay
(``trace=``) is not ported yet: it raises (ROADMAP Queue 1 item 12, with
``sim/traces.py``).

Per-device runtime models: compute speed, availability, mobility.

A ``DeviceFleet`` carries the *dynamic* per-MU state the wireless topology
does not: how fast each MU computes a local iteration (lognormal speed
multipliers — the straggler source), whether it shows up for a round
(Bernoulli availability traces — the dropout source), and where it is
(random-waypoint mobility over the HCN disk, with re-association to the
nearest SBS when it crosses a cluster boundary).

Positions come from one of two mutually exclusive sources: the built-in
random-waypoint integrator (``speed_mps > 0``) or a replayed
``sim.traces.MobilityTrace`` (``trace=``), in which case ``advance``
reads positions off the recorded trajectory at the fleet's accumulated
virtual time instead of integrating.

Everything is driven by one ``numpy`` Generator seeded at construction, so
a fleet replayed from the same seed produces bit-identical traces.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.wireless.topology import HCNTopology, uniform_disk


def waypoint_step(pos, waypoints, budget, rng, radius: float):
    """Advance agents along random-waypoint legs until ``budget`` (metres
    per agent) is spent: partial moves toward the waypoint, arrivals land
    on it, redraw a fresh uniform waypoint and spend the leftover (classic
    zero-pause random waypoint). Mutates ``pos``/``waypoints``/``budget``
    in place and returns ``(pos, waypoints)``.

    The ONE integrator shared by live fleets (``DeviceFleet.advance``) and
    the trace generator (``sim.traces.gen_random_waypoint``), so the two
    can never drift apart. Pass capping: each pass consumes a full
    waypoint leg (~disk radius on average) or zeroes a lane; a fixed small
    count would silently under-move agents for large budgets.
    """
    max_legs = 8 + int(np.ceil(budget.max() / (0.25 * radius)))
    for _ in range(max_legs):
        vec = waypoints - pos
        dist = np.linalg.norm(vec, axis=1)
        moving = budget > 0
        arrive = moving & (dist <= budget)
        if not moving.any():
            break
        # partial move toward the waypoint
        part = moving & ~arrive
        if part.any():
            step = vec[part] / np.maximum(dist[part], 1e-12)[:, None]
            pos[part] += step * budget[part, None]
            budget[part] = 0.0
        # arrivals: land on the waypoint, redraw, spend the leftover
        if arrive.any():
            pos[arrive] = waypoints[arrive]
            budget[arrive] -= dist[arrive]
            waypoints[arrive] = uniform_disk(rng, int(arrive.sum()), radius)
    return pos, waypoints


class DeviceFleet:
    """Dynamic state of the K MUs dropped on an ``HCNTopology``.

    Parameters
    ----------
    compute_sigma : lognormal sigma of the per-MU compute-time multiplier
        (normalised so the multiplier has mean 1; 0 = homogeneous fleet).
    dropout : per-round probability that an MU is unavailable.
    diurnal_amp : amplitude of a sinusoidal modulation of ``dropout`` over
        virtual time (0 = flat availability, the legacy behavior):
        ``p(t) = clip(dropout * (1 + amp * sin(2pi (t/period + phase))), 0, 1)``.
    speed_mps : random-waypoint speed; 0 = static users (paper setting).
    trace : a ``sim.traces.MobilityTrace`` to replay instead of the
        waypoint model: not ported yet, raises.
    """

    def __init__(
        self,
        topo: HCNTopology,
        mus_per_cluster: int,
        *,
        compute_sigma: float = 0.0,
        dropout: float = 0.0,
        diurnal_amp: float = 0.0,
        diurnal_period_s: float = 86400.0,
        diurnal_phase: float = 0.0,
        speed_mps: float = 0.0,
        seed: int = 0,
        compute_mult: Optional[np.ndarray] = None,
        trace=None,
    ):
        self.topo = topo
        self.rng = np.random.default_rng(seed)
        self.pos, self.cid = topo.drop_users(mus_per_cluster)
        self.K = len(self.cid)
        self.dropout = float(dropout)
        self.diurnal_amp = float(diurnal_amp)
        self.diurnal_period_s = float(diurnal_period_s)
        self.diurnal_phase = float(diurnal_phase)
        self.speed_mps = float(speed_mps)
        self._cluster_cache = None
        if trace is not None:
            raise NotImplementedError(
                "mobility trace replay is not ported yet: ROADMAP Queue 1 "
                "item 12 (sim/traces.py)")
        self.trace = None
        if compute_mult is not None:
            self.compute_mult = np.asarray(compute_mult, np.float64)
            assert self.compute_mult.shape == (self.K,)
        elif compute_sigma > 0:
            z = self.rng.standard_normal(self.K)
            # mean-1 lognormal: E[exp(sigma z - sigma^2/2)] = 1
            self.compute_mult = np.exp(compute_sigma * z - compute_sigma**2 / 2)
        else:
            self.compute_mult = np.ones(self.K)
        self._waypoint = self._draw_waypoints(self.K)

    # --- compute ---------------------------------------------------------

    def compute_times(self, base_compute_s: float) -> np.ndarray:
        """Per-MU wall time of ONE local iteration [K]."""
        return base_compute_s * self.compute_mult

    # --- availability ----------------------------------------------------

    def unavailability(self, t: float = 0.0) -> float:
        """Per-MU unavailability probability at virtual time ``t``."""
        if self.diurnal_amp <= 0:
            return self.dropout
        wave = 1.0 + self.diurnal_amp * np.sin(
            2.0 * np.pi * (t / self.diurnal_period_s + self.diurnal_phase)
        )
        return float(np.clip(self.dropout * wave, 0.0, 1.0))

    def draw_available(self, t: float = 0.0) -> np.ndarray:
        """Per-round availability trace: True = MU participates [K] bool.

        Consumes the fleet RNG, so calling once per round yields a
        deterministic per-(seed, round) trace. ``t`` (virtual seconds) only
        matters under a diurnal curve (``diurnal_amp > 0``); with a flat
        curve the draw is bit-identical to the pre-diurnal fleet.
        """
        p = self.dropout if self.diurnal_amp <= 0 else self.unavailability(t)
        if p <= 0:
            return np.ones(self.K, bool)
        return self.rng.uniform(0.0, 1.0, self.K) >= p

    # --- mobility --------------------------------------------------------

    @property
    def mobile(self) -> bool:
        """True when positions change over time (the waypoint model)."""
        return self.speed_mps > 0

    def _draw_waypoints(self, n: int) -> np.ndarray:
        """Uniform waypoints in the HCN disk (random-waypoint model)."""
        return uniform_disk(self.rng, n, self.topo.area_radius)

    def advance(self, dt: float) -> None:
        """Move every MU ``dt`` virtual seconds toward its waypoint.

        An MU that reaches its waypoint inside ``dt`` draws a fresh one and
        keeps moving with the leftover time budget (classic random waypoint,
        zero pause time).
        """
        if self.speed_mps <= 0 or dt <= 0:
            return
        budget = np.full(self.K, dt * self.speed_mps)  # metres left to move
        waypoint_step(self.pos, self._waypoint, budget, self.rng,
                      self.topo.area_radius)

    def reassociate(self, chunk: int = 1 << 17) -> np.ndarray:
        """Re-attach every MU to its nearest SBS; returns new cid [K].

        Streams the [chunk, num_sbs, 2] distance block so a million-MU
        fleet never materialises the full K x N matrix (each row's argmin
        is independent — chunking is bit-exact).
        """
        cid = np.empty(self.K, np.int64)
        for s in range(0, self.K, chunk):
            d = np.linalg.norm(
                self.pos[s:s + chunk, None, :] - self.topo.sbs_pos[None, :, :],
                axis=2,
            )
            cid[s:s + chunk] = np.argmin(d, axis=1)
        self.cid = cid
        self._cluster_cache = None
        return self.cid

    # --- cluster aggregates ----------------------------------------------
    #
    # Membership is queried once per event by the engine, and once per
    # cluster per round by the client selector (``sim.selection``); at
    # fleet scale a fresh ``nonzero`` per query is O(K) each. The CSR cache
    # amortises that to one stable argsort per (re)association epoch, after
    # which any cluster's member list / size / compute max is an O(size)
    # slice.

    def _clusters(self):
        if self._cluster_cache is None:
            order = np.argsort(self.cid, kind="stable")
            starts = np.searchsorted(
                self.cid[order], np.arange(self.topo.num_clusters + 1)
            )
            sizes = np.diff(starts)
            comp_max = np.zeros(self.topo.num_clusters)
            np.maximum.at(comp_max, self.cid, self.compute_mult)
            self._cluster_cache = (order, starts, sizes, comp_max)
        return self._cluster_cache

    def cluster_sizes(self) -> np.ndarray:
        """MUs attached per cluster [num_clusters] int (cached)."""
        return self._clusters()[2]

    def cluster_comp_max(self, base_compute_s: float) -> np.ndarray:
        """Slowest member's one-iteration wall time per cluster
        [num_clusters]; 0 for empty clusters (cached)."""
        return base_compute_s * self._clusters()[3]

    def cluster_members_csr(self):
        """CSR view of membership: ``(order, starts)`` with cluster ``n``'s
        member ids (ascending) at ``order[starts[n]:starts[n+1]]``."""
        order, starts, _, _ = self._clusters()
        return order, starts

    # --- helpers ---------------------------------------------------------

    def cluster_members(self, n: int) -> np.ndarray:
        """Indices of the MUs currently attached to cluster ``n``
        (ascending — the stable argsort preserves id order, matching the
        historical ``nonzero`` scan bit-for-bit)."""
        order, starts, _, _ = self._clusters()
        return order[starts[n]:starts[n + 1]]
