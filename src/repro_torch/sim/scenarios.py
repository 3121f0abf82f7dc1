"""Named scenario registry for the HCN simulator: the port of
``repro.sim.scenarios``, the whole registry copied.

The port runs every scenario, the two depth-3 ones (``hier-3tier``,
``hier-deadline``) included.

Each scenario bundles a ``SimConfig`` (fleet + discipline knobs) with the
``HFLConfig`` overrides that make it meaningful, so
``--scenario paper-fig3`` is the whole story on the CLI:

  * ``paper-fig3``  — paper-faithful static fleet, lockstep, the paper's
                      φ settings; reproduces Fig. 3's HFL-vs-FL ordering.
  * ``stragglers``  — heavy-tailed compute distribution + per-round
                      deadline drop.
  * ``mobility``    — random-waypoint MUs re-associating to the nearest
                      SBS; the radio is re-priced every period.
  * ``dropout``     — Bernoulli availability traces; empty clusters sit
                      rounds out.
  * ``async``       — clusters sync on their own clocks with
                      staleness-weighted consensus.
  * ``trace-replay`` — recorded mobility (a synthetic random-waypoint
                      trace by default; any CSV/JSONL trace via
                      ``trace_file``/``--trace-in``) drives positions,
                      data residency follows re-association (``move``),
                      and the async discipline advances one cluster per
                      event — the masked-train-step workload.
  * ``manhattan``   — street-grid mobility replay under the deadline
                      discipline: abrupt, correlated re-associations plus
                      straggler drop with sub-carrier reclamation.
  * ``fault-dead-cluster`` — paper-fig3 layout with one cluster's MUs
                      forced unavailable every round (post-RNG-draw mask);
                      the health monitor's dead-cluster anomaly must fire.
  * ``diurnal``     — lockstep under a sinusoidal availability curve:
                      unavailability swings through a compressed "day"
                      within the run, so participation (and survivor
                      pricing) breathes round to round.
  * ``flash-crowd`` — ``hotspot-drift`` trace replay: an oversubscribed
                      crowd converges on one cell while a surging
                      availability wave rides on top; ``duplicate``
                      residency accrues shard copies where the crowd goes.
  * ``scale-1m``    — LIVE training + mobility + residency at 1.05M MUs:
                      oversubscribed fleet (150k MUs/cluster, cluster-
                      subsampled batches), streamed single-subcarrier
                      pricing (``rate_model='single'``), batched mobility
                      bookkeeping (``reprice_interval_s``).
  * ``scale-100k``  — DEPRECATED alias of the ``scale-1m`` live path at
                      ~105k MUs. (Historically kind "sampling": latency
                      aggregates only, silently no training —
                      ``run_scale_sampling`` keeps that sweep available
                      as an explicit function call.)
  * ``hier-3tier``  — depth-3 hierarchy (MU → SBS → edge → cloud):
                      the tiered cascade fires tier 1 every period and the
                      root every ``tiers[2].period`` rounds, with per-tier
                      Ω/error-feedback and per-tier fronthaul pricing.
  * ``hier-deadline`` — the depth-3 tree with the DEADLINE discipline on
                      the middle tier (``tiers[1]``): straggler MUs are
                      dropped at the per-round deadline and their
                      sub-carriers reclaimed by the survivors, while the
                      root keeps its lockstep cadence.
  * ``prate-biased`` — paper-fig3 layout with ``prate=0.5`` rate-biased
                      client selection: each round only the fastest half
                      of every cell trains, cutting measured access-UL
                      bits roughly in half vs full participation.
"""
from __future__ import annotations

import dataclasses
import warnings
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from repro_torch.configs.base import HFLConfig, SimConfig
from repro_torch.data.federated import ResidencyTracker
from repro_torch.sim.devices import DeviceFleet
from repro_torch.sim.engine import SimEngine
from repro_torch.wireless.latency import LatencyParams
from repro_torch.wireless.qam import optimal_rate_vec
from repro_torch.wireless.topology import HCNTopology, uniform_disk

PAPER_PHIS = dict(phi_mu_ul=0.99, phi_sbs_dl=0.9, phi_sbs_ul=0.9, phi_mbs_dl=0.9)


@dataclass(frozen=True)
class Scenario:
    name: str
    kind: str  # "train" | "sampling"
    sim: SimConfig
    hfl: dict = field(default_factory=dict)  # HFLConfig overrides
    note: str = ""


SCENARIOS = {
    "paper-fig3": Scenario(
        name="paper-fig3", kind="train",
        sim=SimConfig(scenario="paper-fig3", discipline="lockstep"),
        # pins the paper's §V-A setup: 7-hexagon HCN, K=4 MUs/cluster, H=2.
        # At these φ the Fig.3 speedup is ~2.5x > H, so one whole HFL
        # period (H iterations + consensus) finishes before ONE FL
        # iteration — the figure's headline ordering.
        hfl=dict(num_clusters=7, mus_per_cluster=4, period=2,
                 sync_mode="sparse", **PAPER_PHIS),
        note="static fleet, lockstep, paper φ + topology; Fig.3 ordering",
    ),
    "stragglers": Scenario(
        name="stragglers", kind="train",
        sim=SimConfig(scenario="stragglers", discipline="deadline",
                      compute_sigma=1.0, deadline_factor=1.25),
        hfl=dict(sync_mode="sparse", **PAPER_PHIS),
        note="lognormal(σ=1) compute; deadline drops the tail",
    ),
    "mobility": Scenario(
        name="mobility", kind="train",
        sim=SimConfig(scenario="mobility", discipline="lockstep",
                      speed_mps=30.0),
        hfl=dict(sync_mode="sparse", **PAPER_PHIS),
        note="random-waypoint @30 m/s, nearest-SBS re-association",
    ),
    "dropout": Scenario(
        name="dropout", kind="train",
        sim=SimConfig(scenario="dropout", discipline="lockstep", dropout=0.3),
        hfl=dict(sync_mode="sparse", **PAPER_PHIS),
        note="30% per-round unavailability; survivors carry the round",
    ),
    "async": Scenario(
        name="async", kind="train",
        sim=SimConfig(scenario="async", discipline="async", compute_sigma=0.5),
        # sparse downlink with per-cluster DL error buffers: each cluster
        # pulls only the top-(1-φ_mbs_dl) of what it is missing
        hfl=dict(sync_mode="sparse", async_dl_sparse=True, **PAPER_PHIS),
        note="per-cluster clocks, staleness-weighted consensus, sparse DL",
    ),
    "trace-replay": Scenario(
        name="trace-replay", kind="train",
        sim=SimConfig(scenario="trace-replay", discipline="async",
                      compute_sigma=0.5, trace_model="random-waypoint",
                      trace_speed_mps=30.0, residency="move"),
        # async + sparse DL: the workload where the masked train step and
        # mobile data residency both bite
        hfl=dict(sync_mode="sparse", async_dl_sparse=True, **PAPER_PHIS),
        note="replayed mobility trace; shards follow re-association; "
             "one active cluster per event (masked train step)",
    ),
    "manhattan": Scenario(
        name="manhattan", kind="train",
        sim=SimConfig(scenario="manhattan", discipline="deadline",
                      compute_sigma=0.5, deadline_factor=1.5,
                      trace_model="manhattan", residency="move"),
        hfl=dict(sync_mode="sparse", **PAPER_PHIS),
        note="street-grid trace replay + deadline drop; survivors inherit "
             "reclaimed sub-carriers",
    ),
    "fault-dead-cluster": Scenario(
        name="fault-dead-cluster", kind="train",
        sim=SimConfig(scenario="fault-dead-cluster", discipline="lockstep",
                      dropout=0.1, fault_dead_cluster=2),
        hfl=dict(num_clusters=7, mus_per_cluster=4, period=2,
                 sync_mode="sparse", **PAPER_PHIS),
        note="paper-fig3 layout with cluster 2's MUs forced dead every "
             "round (post-draw mask): exercises the health monitor's "
             "dead/starved-cluster anomaly",
    ),
    "diurnal": Scenario(
        name="diurnal", kind="train",
        sim=SimConfig(scenario="diurnal", discipline="lockstep", dropout=0.3,
                      diurnal_amp=0.9, diurnal_period_s=240.0,
                      diurnal_phase=0.75),
        hfl=dict(sync_mode="sparse", **PAPER_PHIS),
        note="sinusoidal availability (a compressed 240s day): "
             "participation breathes from ~3% to ~57% unavailable",
    ),
    "flash-crowd": Scenario(
        name="flash-crowd", kind="train",
        sim=SimConfig(scenario="flash-crowd", discipline="async",
                      compute_sigma=0.5, trace_model="hotspot-drift",
                      residency="duplicate", fleet_mus_per_cluster=16,
                      dropout=0.2, diurnal_amp=1.0, diurnal_period_s=120.0,
                      diurnal_phase=-0.25),
        hfl=dict(sync_mode="sparse", async_dl_sparse=True, **PAPER_PHIS),
        note="hotspot-drift crowd surge: oversubscribed fleet converges on "
             "one cell, duplicate residency accrues copies, availability "
             "swings with a 120s wave",
    ),
    "scale-1m": Scenario(
        name="scale-1m", kind="train",
        sim=SimConfig(scenario="scale-1m", discipline="async",
                      compute_sigma=0.5, dropout=0.1, speed_mps=30.0,
                      residency="move", fleet_mus_per_cluster=150_000,
                      rate_model="single", reprice_interval_s=600.0),
        hfl=dict(num_clusters=7, mus_per_cluster=4, period=2,
                 sync_mode="sparse", async_dl_sparse=True, **PAPER_PHIS),
        note="1.05M-MU LIVE fleet: waypoint mobility + move residency + "
             "cluster-subsampled training, streamed single-subcarrier "
             "pricing, mobility bookkeeping batched per 600 virtual s",
    ),
    "scale-100k": Scenario(
        name="scale-100k", kind="train",
        sim=SimConfig(scenario="scale-100k", discipline="async",
                      compute_sigma=0.5, dropout=0.1, speed_mps=30.0,
                      residency="move", fleet_mus_per_cluster=15_000,
                      rate_model="single", reprice_interval_s=600.0),
        hfl=dict(num_clusters=7, mus_per_cluster=4, period=2,
                 sync_mode="sparse", async_dl_sparse=True, **PAPER_PHIS),
        note="DEPRECATED alias of the scale-1m live path at 105k MUs "
             "(the old aggregate-only sampling is run_scale_sampling)",
    ),
    "hier-3tier": Scenario(
        name="hier-3tier", kind="train",
        sim=SimConfig(scenario="hier-3tier", discipline="lockstep"),
        # MU -> SBS -> edge -> cloud: 2 edges x 2 SBS x 4 MUs. Tier 1
        # consensus every 2 iterations, the root every 2 tier-1 rounds;
        # each hop runs its own Omega/error-feedback at the paper's phi.
        hfl=dict(sync_mode="sparse", tiers=(
            dict(fanout=4, period=1, phi_up=0.99, phi_down=0.9),
            dict(fanout=2, period=2, phi_up=0.9, phi_down=0.9,
                 beta_up=0.5, beta_down=0.2),
            dict(fanout=2, period=2, phi_up=0.9, phi_down=0.9,
                 beta_up=0.5, beta_down=0.2),
        )),
        note="depth-3 tiered consensus: 2 edges x 2 SBS x 4 MUs, root "
             "fires every 2 tier-1 rounds, per-tier fronthaul pricing",
    ),
    "hier-deadline": Scenario(
        name="hier-deadline", kind="train",
        sim=SimConfig(scenario="hier-deadline", compute_sigma=1.0,
                      deadline_factor=1.25),
        # hier-3tier's tree with the DEADLINE discipline on the middle
        # tier (boundary 1): straggler MUs that would blow the round
        # deadline are dropped and their sub-carriers reclaimed by the
        # survivors (Alg. 2 re-allocation), while the tiers above keep
        # their lockstep cadence. Exercises per-tier disciplines without
        # the legacy fleet-wide SimConfig.discipline knob.
        hfl=dict(sync_mode="sparse", tiers=(
            dict(fanout=4, period=1, phi_up=0.99, phi_down=0.9),
            dict(fanout=2, period=2, phi_up=0.9, phi_down=0.9,
                 beta_up=0.5, beta_down=0.2, discipline="deadline"),
            dict(fanout=2, period=2, phi_up=0.9, phi_down=0.9,
                 beta_up=0.5, beta_down=0.2),
        )),
        note="depth-3 tree, deadline discipline on the middle tier: "
             "straggler drop + subcarrier reclaim under a lockstep root",
    ),
    "prate-biased": Scenario(
        name="prate-biased", kind="train",
        sim=SimConfig(scenario="prate-biased", discipline="lockstep",
                      compute_sigma=0.5, prate=0.5, selection="biased"),
        hfl=dict(num_clusters=7, mus_per_cluster=4, period=2,
                 sync_mode="sparse", **PAPER_PHIS),
        note="paper-fig3 layout, prate=0.5 rate-biased selection: the "
             "fastest half of each cell trains; access-UL bits halve",
    ),
}


def get_scenario(name: str) -> Scenario:
    if name not in SCENARIOS:
        raise KeyError(f"unknown scenario {name!r}; choose from {sorted(SCENARIOS)}")
    if name == "scale-100k":
        warnings.warn(
            "scenario 'scale-100k' used to SILENTLY sample latency "
            "aggregates without training; it is now a deprecated alias of "
            "the live 'scale-1m' path at ~105k MUs (real training + "
            "mobility + residency). Use --scenario scale-1m going forward, "
            "or call run_scale_sampling() for the old aggregates-only "
            "sweep.", UserWarning, stacklevel=2)
    return SCENARIOS[name]


# the reference HFLConfig's legacy two-level keywords, which the registry
# above uses -> (tier, TierConfig field)
_LEGACY_TIER_KEYS = {
    "mus_per_cluster": (0, "fanout"), "phi_mu_ul": (0, "phi_up"),
    "phi_sbs_dl": (0, "phi_down"), "num_clusters": (1, "fanout"),
    "period": (1, "period"), "phi_sbs_ul": (1, "phi_up"),
    "phi_mbs_dl": (1, "phi_down"), "beta_s": (1, "beta_up"),
    "beta_m": (1, "beta_down"),
}


def apply_hfl_overrides(scn: Scenario, hfl_cfg: HFLConfig) -> HFLConfig:
    """Scenario-mandated HFL settings (φ, sync mode) onto a base config.
    The legacy two-level keywords reshape the depth-2 ``tiers`` as the
    reference's ``HFLConfig`` constructor does."""
    if not scn.hfl:
        return hfl_cfg
    legacy = {k: v for k, v in scn.hfl.items() if k in _LEGACY_TIER_KEYS}
    cfg = dataclasses.replace(hfl_cfg, **{k: v for k, v in scn.hfl.items()
                                          if k not in legacy})
    if not legacy:
        return cfg
    if cfg.depth != 2:
        raise ValueError(f"legacy two-level keyword(s) {sorted(legacy)} are "
                         f"ambiguous on a depth-{cfg.depth} hierarchy")
    per_tier = ({}, {})
    for k, v in legacy.items():
        t, f = _LEGACY_TIER_KEYS[k]
        per_tier[t][f] = v
    return dataclasses.replace(cfg, tiers=tuple(
        dataclasses.replace(tc, **kw) for tc, kw in zip(cfg.tiers, per_tier)))


def build_trace(sim: SimConfig, n_mus: int, topo: HCNTopology):
    """Mobility trace for a scenario: load ``trace_file`` if set, else run
    the named synthetic generator; None when the scenario has neither.
    ``n_mus`` is the FLEET's MU count (which exceeds the training slots
    when ``fleet_mus_per_cluster`` oversubscribes)."""
    from repro_torch.sim import traces as tr

    if sim.trace_file is not None:
        trace = tr.MobilityTrace.load(sim.trace_file)
        if trace.K != n_mus:
            raise ValueError(
                f"trace {sim.trace_file} has {trace.K} MUs but the fleet "
                f"needs {n_mus}")
        return trace
    if sim.trace_model is not None:
        return tr.generate(
            sim.trace_model, n_mus, sim.trace_duration_s,
            radius=topo.area_radius, seed=sim.seed,
            speed_mps=sim.trace_speed_mps if sim.trace_speed_mps > 0 else None,
            dt=sim.trace_dt_s,
        )
    return None


def build_engine(
    scn: Scenario,
    hfl_cfg: HFLConfig,
    *,
    lp: Optional[LatencyParams] = None,
    seed: Optional[int] = None,
    trace_file: Optional[str] = None,
    residency: Optional[str] = None,
    obs=None,
) -> SimEngine:
    """Topology + fleet (+ mobility trace + residency tracker) + engine
    for a training scenario. ``seed``/``trace_file``/``residency``/``obs``
    override the scenario's ``SimConfig`` (the train CLI's
    ``--sim-seed``/``--trace-in``/``--residency`` and its telemetry
    flags' ``ObsConfig``)."""
    assert scn.kind == "train", f"{scn.name} is a sampling scenario"
    sim = scn.sim
    over = {}
    if seed is not None:
        over["seed"] = seed
    if trace_file is not None:
        over["trace_file"] = trace_file
        over["trace_model"] = None
    if residency is not None:
        over["residency"] = residency
    if obs is not None:
        over["obs"] = obs
    if over:
        sim = dataclasses.replace(sim, **over)
    if (sim.trace_file or sim.trace_model) and sim.speed_mps > 0:
        # replay REPLACES the waypoint integrator: --trace-in on a scenario
        # with built-in mobility silences its speed_mps
        sim = dataclasses.replace(sim, speed_mps=0.0)
    topo = HCNTopology(num_clusters=hfl_cfg.num_clusters, seed=sim.seed)
    # the fleet may oversubscribe the training slots (fleet-scale runs)
    fleet_mpc = sim.fleet_mus_per_cluster or hfl_cfg.mus_per_cluster
    trace = build_trace(sim, hfl_cfg.num_clusters * fleet_mpc, topo)
    fleet = DeviceFleet(
        topo, fleet_mpc,
        compute_sigma=sim.compute_sigma, dropout=sim.dropout,
        diurnal_amp=sim.diurnal_amp, diurnal_period_s=sim.diurnal_period_s,
        diurnal_phase=sim.diurnal_phase,
        speed_mps=sim.speed_mps, seed=sim.seed, trace=trace,
    )
    tracker = None
    if sim.residency != "static":
        tracker = ResidencyTracker(fleet.cid, hfl_cfg.num_clusters,
                                   policy=sim.residency)
    return SimEngine(
        period=hfl_cfg.tiers[1].period, hfl_cfg=hfl_cfg, sim_cfg=sim,
        topo=topo, fleet=fleet, lp=lp if lp is not None else LatencyParams(),
        residency=tracker,
    )


# ---------------------------------------------------------------------------
# scale-100k: vectorized latency sampling, aggregates only
# ---------------------------------------------------------------------------


def run_scale_sampling(
    scn: Scenario,
    *,
    lp: Optional[LatencyParams] = None,
    n_users: int = 100_000,
    chunk: int = 10_000,
    phi_ul: float = 0.99,
) -> dict:
    """Latency statistics for ``n_users`` MUs without per-user state.

    Streams chunks of positions: uniform drop on the HCN disk, nearest-SBS
    association, vectorized single-subcarrier UL rate (golden-section over
    the whole chunk at once). Only aggregates survive a chunk — a rate
    histogram, min/max/mean — so memory is O(chunk + bins) no matter how
    many users are sampled.
    """
    lp = lp if lp is not None else LatencyParams()
    topo = HCNTopology(seed=scn.sim.seed)
    rng = np.random.default_rng(scn.sim.seed)
    kw = dict(B0=lp.B0, Pmax=lp.p_mu, N0=lp.n0, alpha=lp.alpha, ber=lp.ber)
    edges = np.logspace(-2.0, 10.0, 241)  # rate bins [bps], ~8 bins/decade
    hist = np.zeros(len(edges) - 1)
    under = 0  # rates below edges[0]: folded into the cdf, not dropped
    mn, mx, total, count = np.inf, 0.0, 0.0, 0
    for start in range(0, n_users, chunk):
        m = min(chunk, n_users - start)
        pos = uniform_disk(rng, m, topo.area_radius)
        d = np.linalg.norm(pos[:, None, :] - topo.sbs_pos[None, :, :], axis=2)
        d = np.maximum(d.min(axis=1), 1.0)
        rates = optimal_rate_vec(d, m=1, **kw)
        hist += np.histogram(rates, edges)[0]
        under += int((rates < edges[0]).sum())
        mn = min(mn, float(rates.min()))
        mx = max(mx, float(rates.max()))
        total += float(rates.sum())
        count += m
    cdf = (under + np.cumsum(hist)) / count
    pct = lambda p: float(edges[min(int(np.searchsorted(cdf, p)) + 1, len(edges) - 1)])
    payload = lp.payload(phi_ul)
    return {
        "scenario": scn.name,
        "n_users": count,
        "rate_min_bps": mn,
        "rate_mean_bps": total / count,
        "rate_max_bps": mx,
        "rate_p5_bps": pct(0.05),
        "rate_p50_bps": pct(0.50),
        "rate_p95_bps": pct(0.95),
        "t_ul_worst_s": payload / mn,
        "t_ul_median_s": payload / pct(0.50),
    }
