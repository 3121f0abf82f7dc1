"""Trace-driven mobility replay: recorded MU positions drive the simulator.

The port's copy of ``repro.sim.traces`` (numpy only, the same RNG streams
and call order, so a seed gives the same trace bit for bit, and the same
CSV/JSONL schema, so either package loads what the other saved).

The built-in random-waypoint model (``sim.devices``) synthesises motion on
the fly; this module replaces it with *replay* of an external trace, so the
simulator can be driven by real mobility datasets (or by the bundled
synthetic generators) on the byte-accurate time axis the measured-bits
accounting (PR 3) established.

Trace schema (documented, versioned by column names, not position):

  * CSV — a header line ``t,mu_id,x,y`` followed by one row per sample:
    ``t`` virtual seconds (float, non-negative), ``mu_id`` integer in
    ``0..K-1``, ``x``/``y`` metres in the simulator's HCN frame (MBS at the
    origin). Extra columns are ignored.
  * JSONL — one JSON object per line with the same four keys.

Rows may appear in any order and per-MU sample times may be irregular: the
trace is grouped by ``mu_id`` and each MU's position at an arbitrary query
time is piecewise-linear interpolated between its own samples (held
constant before its first and after its last sample). Every ``mu_id`` in
``0..K-1`` must appear at least once; K is inferred as ``max(mu_id)+1``.

Replay is exact: a ``DeviceFleet`` built with ``trace=`` reads positions
from ``MobilityTrace.at(t)`` instead of integrating waypoints, so two runs
over the same trace file and seed produce bit-identical loss/latency
traces (tested).

Synthetic generators (all return a ``MobilityTrace``):

  * ``gen_random_waypoint`` — the classic zero-pause model on the HCN disk;
    the self-test baseline (replaying it should look like the built-in
    ``mobility`` scenario).
  * ``gen_manhattan_grid``  — MUs move along the lines of an axis-aligned
    street grid, choosing a direction uniformly at each intersection
    (urban canyon motion: association changes are abrupt and correlated).
  * ``gen_hotspot_drift``   — MUs orbit a set of attraction points that
    drift across the disk and are re-drawn occasionally (flash-crowd /
    commuter-flow motion: clusters drain and flood together, the regime
    where data residency matters most).
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Optional

import numpy as np

from repro_torch.wireless.topology import uniform_disk

TRACE_COLUMNS = ("t", "mu_id", "x", "y")
GENERATORS = ("random-waypoint", "manhattan", "hotspot-drift")


@dataclass
class MobilityTrace:
    """Per-MU position samples: ``times[k]`` [S_k] sorted, ``xy[k]`` [S_k,2].

    Stored per-MU (not as a dense [S, K, 2] block) so irregular external
    traces — different sample clocks per device — replay without resampling.
    """

    times: list  # K arrays of sample times, each sorted ascending
    xy: list     # K arrays [S_k, 2]

    def __post_init__(self):
        assert len(self.times) == len(self.xy) and len(self.times) > 0
        for k, (t, p) in enumerate(zip(self.times, self.xy)):
            if len(t) == 0:
                raise ValueError(f"mu_id {k} has no samples")
            if len(t) != len(p):
                raise ValueError(f"mu_id {k}: {len(t)} times vs {len(p)} positions")
            if np.any(np.diff(t) < 0):
                raise ValueError(f"mu_id {k}: sample times not sorted")

    @property
    def K(self) -> int:
        return len(self.times)

    @property
    def duration(self) -> float:
        return float(max(t[-1] for t in self.times))

    def at(self, t: float) -> np.ndarray:
        """Interpolated positions [K, 2] at virtual time ``t`` (clamped to
        each MU's own sample span)."""
        out = np.empty((self.K, 2))
        for k in range(self.K):
            tk, pk = self.times[k], self.xy[k]
            out[k, 0] = np.interp(t, tk, pk[:, 0])
            out[k, 1] = np.interp(t, tk, pk[:, 1])
        return out

    # --- construction ----------------------------------------------------

    @classmethod
    def from_records(cls, records) -> "MobilityTrace":
        """records: iterable of (t, mu_id, x, y); any order, any per-MU clock."""
        rows = sorted((float(t), int(k), float(x), float(y))
                      for t, k, x, y in records)
        if not rows:
            raise ValueError("empty trace")
        ids = sorted({r[1] for r in rows})
        K = ids[-1] + 1
        if ids[0] < 0:
            raise ValueError("mu_id must be non-negative")
        if len(ids) != K:
            missing = sorted(set(range(K)) - set(ids))
            raise ValueError(f"trace covers mu_ids {ids[0]}..{K-1} but is "
                             f"missing {missing[:8]}")
        times = [[] for _ in range(K)]
        xy = [[] for _ in range(K)]
        for t, k, x, y in rows:
            if t < 0:
                raise ValueError(f"negative sample time {t}")
            times[k].append(t)
            xy[k].append((x, y))
        return cls([np.asarray(t) for t in times],
                   [np.asarray(p, np.float64) for p in xy])

    @classmethod
    def from_dense(cls, t, pos) -> "MobilityTrace":
        """t [S], pos [S, K, 2]: one shared sample clock (generator output)."""
        t = np.asarray(t, np.float64)
        pos = np.asarray(pos, np.float64)
        return cls([t] * pos.shape[1], [pos[:, k] for k in range(pos.shape[1])])

    # --- serialization ---------------------------------------------------

    def iter_records(self):
        for k in range(self.K):
            for t, (x, y) in zip(self.times[k], self.xy[k]):
                yield float(t), k, float(x), float(y)

    def save(self, path: str) -> None:
        """CSV for ``.csv``, JSONL otherwise (one object per line)."""
        recs = sorted(self.iter_records())
        with open(path, "w") as f:
            if str(path).endswith(".csv"):
                f.write(",".join(TRACE_COLUMNS) + "\n")
                for t, k, x, y in recs:
                    f.write(f"{t!r},{k},{x!r},{y!r}\n")
            else:
                for t, k, x, y in recs:
                    f.write(json.dumps(
                        {"t": t, "mu_id": k, "x": x, "y": y}) + "\n")

    @classmethod
    def load(cls, path: str) -> "MobilityTrace":
        """Sniffs the format from the first non-empty line: ``{`` = JSONL,
        anything else = CSV with a ``t,mu_id,x,y`` header."""
        with open(path) as f:
            lines = [ln.strip() for ln in f if ln.strip()]
        if not lines:
            raise ValueError(f"empty trace file {path}")
        recs = []
        if lines[0].startswith("{"):
            for ln in lines:
                o = json.loads(ln)
                recs.append((o["t"], o["mu_id"], o["x"], o["y"]))
        else:
            header = [h.strip() for h in lines[0].split(",")]
            try:
                cols = [header.index(c) for c in TRACE_COLUMNS]
            except ValueError:
                raise ValueError(
                    f"CSV trace needs a header with columns {TRACE_COLUMNS}, "
                    f"got {header}") from None
            for ln in lines[1:]:
                parts = ln.split(",")
                recs.append(tuple(parts[c] for c in cols))
        return cls.from_records(recs)


# ---------------------------------------------------------------------------
# Synthetic generators
# ---------------------------------------------------------------------------


def gen_random_waypoint(
    K: int, duration: float, *, radius: float = 750.0, speed_mps: float = 30.0,
    dt: float = 5.0, seed: int = 0,
) -> MobilityTrace:
    """Zero-pause random waypoint on a disk, sampled every ``dt`` seconds
    (the same ``devices.waypoint_step`` integrator that drives live
    fleets, so replaying this trace IS the built-in mobility model)."""
    from repro_torch.sim.devices import waypoint_step

    rng = np.random.default_rng(seed)
    pos = uniform_disk(rng, K, radius)
    wp = uniform_disk(rng, K, radius)
    ts = np.arange(0.0, duration + 0.5 * dt, dt)
    out = np.empty((len(ts), K, 2))
    out[0] = pos
    for i in range(1, len(ts)):
        budget = np.full(K, dt * speed_mps)
        waypoint_step(pos, wp, budget, rng, radius)
        out[i] = pos
    return MobilityTrace.from_dense(ts, out)


def gen_manhattan_grid(
    K: int, duration: float, *, radius: float = 750.0, speed_mps: float = 15.0,
    block: float = 125.0, dt: float = 5.0, seed: int = 0,
    turn_prob: float = 0.5,
) -> MobilityTrace:
    """Street-grid motion: MUs travel along axis-aligned grid lines of
    spacing ``block``, picking a new axis direction with probability
    ``turn_prob`` at each intersection and U-turning at the disk edge."""
    rng = np.random.default_rng(seed)
    # snap starting points onto grid lines: one coordinate on a multiple of
    # `block`, the other free — everyone starts mid-street, not mid-building
    pos = uniform_disk(rng, K, radius * 0.9)
    on_x_street = rng.uniform(size=K) < 0.5  # moving along x: y is snapped
    snap = lambda v: np.round(v / block) * block
    pos[on_x_street, 1] = snap(pos[on_x_street, 1])
    pos[~on_x_street, 0] = snap(pos[~on_x_street, 0])
    # heading: +-1 along the unsnapped axis
    sgn = np.where(rng.uniform(size=K) < 0.5, 1.0, -1.0)
    ts = np.arange(0.0, duration + 0.5 * dt, dt)
    out = np.empty((len(ts), K, 2))
    out[0] = pos
    # bounded passes: each pass normally consumes a whole block (or the
    # rest of the budget); the cap guards against ulp-sized legs when a
    # float lands a hair short of an intersection
    max_legs = 8 + int(np.ceil(dt * speed_mps / block))
    for i in range(1, len(ts)):
        budget = np.full(K, dt * speed_mps)
        for _ in range(max_legs):
            if budget.max() <= 1e-9:
                break
            axis = np.where(on_x_street, 0, 1)
            ahead = pos[np.arange(K), axis]
            # distance to the next intersection in the heading direction
            nxt = np.where(sgn > 0, (np.floor(ahead / block) + 1) * block,
                           (np.ceil(ahead / block) - 1) * block)
            leg = np.minimum(np.abs(nxt - ahead), budget)
            leg = np.where(budget > 1e-9, np.maximum(leg, 0.0), 0.0)
            pos[np.arange(K), axis] = ahead + sgn * leg
            budget = budget - leg
            at_xing = (budget > 1e-9)
            if at_xing.any():
                # at an intersection: maybe turn onto the cross street
                turn = at_xing & (rng.uniform(size=K) < turn_prob)
                if turn.any():
                    # landing exactly on the intersection keeps both
                    # coordinates on grid lines, so swapping axes is legal
                    pos[turn] = np.round(pos[turn] / block) * block
                    on_x_street = np.where(turn, ~on_x_street, on_x_street)
                sgn = np.where(at_xing & (rng.uniform(size=K) < 0.5),
                               -sgn, sgn)
            # U-turn anyone about to leave the disk — retreating along the
            # CURRENT street (a radial rescale would knock the snapped
            # street coordinate off its grid line for good)
            over = np.linalg.norm(pos, axis=1) > radius
            if over.any():
                sgn = np.where(over, -sgn, sgn)
                idx = np.nonzero(over)[0]
                ax = np.where(on_x_street[idx], 0, 1)
                fixed = pos[idx, 1 - ax]
                lim = np.sqrt(np.maximum(radius**2 - fixed**2, 0.0))
                pos[idx, ax] = np.clip(pos[idx, ax], -lim, lim)
        out[i] = pos
    return MobilityTrace.from_dense(ts, out)


def gen_hotspot_drift(
    K: int, duration: float, *, radius: float = 750.0, speed_mps: float = 20.0,
    n_hotspots: int = 3, drift_mps: float = 5.0, switch_prob: float = 0.02,
    dt: float = 5.0, seed: int = 0,
) -> MobilityTrace:
    """Flash-crowd motion: MUs head toward drifting hotspots, occasionally
    switching allegiance — whole clusters drain and flood together."""
    rng = np.random.default_rng(seed)
    pos = uniform_disk(rng, K, radius)
    hot = uniform_disk(rng, n_hotspots, radius * 0.8)
    hot_v = rng.normal(scale=drift_mps, size=(n_hotspots, 2))
    target = rng.integers(0, n_hotspots, K)
    ts = np.arange(0.0, duration + 0.5 * dt, dt)
    out = np.empty((len(ts), K, 2))
    out[0] = pos
    for i in range(1, len(ts)):
        # hotspots drift (reflected at the disk edge)
        hot = hot + hot_v * dt
        over = np.linalg.norm(hot, axis=1) > radius * 0.9
        hot_v[over] *= -1.0
        hot[over] *= (radius * 0.9) / np.maximum(
            np.linalg.norm(hot[over], axis=1), 1e-12)[:, None]
        # some MUs switch hotspot
        sw = rng.uniform(size=K) < switch_prob
        if sw.any():
            target[sw] = rng.integers(0, n_hotspots, int(sw.sum()))
        # move toward the hotspot with lateral jitter
        vec = hot[target] - pos
        dist = np.linalg.norm(vec, axis=1)
        step = np.minimum(dist, dt * speed_mps)
        dirn = vec / np.maximum(dist, 1e-12)[:, None]
        jitter = rng.normal(scale=0.2 * dt * speed_mps, size=(K, 2))
        pos = pos + dirn * step[:, None] + jitter
        r = np.linalg.norm(pos, axis=1)
        out_of_disk = r > radius
        pos[out_of_disk] *= radius / r[out_of_disk, None]
        out[i] = pos
    return MobilityTrace.from_dense(ts, out)


def generate(model: str, K: int, duration: float, *, radius: float = 750.0,
             seed: int = 0, speed_mps: Optional[float] = None,
             dt: float = 5.0) -> MobilityTrace:
    """Dispatch on generator name (``GENERATORS``); ``speed_mps=None`` keeps
    each model's characteristic default speed."""
    kw = dict(radius=radius, seed=seed, dt=dt)
    if speed_mps is not None:
        kw["speed_mps"] = speed_mps
    if model == "random-waypoint":
        return gen_random_waypoint(K, duration, **kw)
    if model == "manhattan":
        return gen_manhattan_grid(K, duration, **kw)
    if model == "hotspot-drift":
        return gen_hotspot_drift(K, duration, **kw)
    raise KeyError(f"unknown trace generator {model!r}; choose from {GENERATORS}")
