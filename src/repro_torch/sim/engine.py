"""Simulation engine: wall-clock scenario runs of the real training loop
(the port of ``repro.sim.engine``, depth 2, the synchronous disciplines).

Couples three layers:

  * the wireless model (``repro_torch.wireless.latency``) — per-cluster
    UL/DL times, fronthaul, frequency reuse — evaluated against the fleet's
    *current* positions each round, so mobility changes the time axis;
  * the device runtime model (``repro_torch.sim.devices``) — per-MU
    compute times, availability, mobility;
  * the *real* training loop (``core.hfl.make_cluster_train_step`` /
    ``make_sync``) on the card — the accuracy axis is produced by actual
    SGD on actual models, not a convergence proxy.

Time is virtual: the clock, the fleet and the pricing are the reference's
numpy code with the reference's RNG streams and draw order, so a run's
timeline (every trace row's ``t``, ``iter_s``, ``sync_s``, ``dropped``,
``deadline_s``, ``bits_*``) is bit-identical to the reference's for the
same (scenario, seed). No torch RNG enters it.

Two sync disciplines (``SimConfig.discipline``):

  * ``lockstep`` — the paper's schedule: every cluster runs H intra-cluster
    iterations, the MBS consensus happens when the slowest cluster arrives
    (Γ^period = H·max_n Γ_n + Θ^U + Θ^D, eq. 21).
  * ``deadline`` — straggler drop: each round has a deadline
    (``deadline_factor`` × median per-MU round time); MUs that would finish
    late are dropped for the round (their batch rows are resampled from the
    participants) and the round completes at the slowest surviving MU.

A cluster with no participant sits the round out: its params and
optimizer rows stay bitwise as they were, while ``step`` advances and its
loss still counts in the row's mean, as in the reference (whose vmapped
step computes every cluster and ``_merge_clusters`` restores the sat-out
rows). The port's train step updates in place, so the engine passes the
``keep`` mask to it and the step computes a sat-out cluster's loss with no
update (``core.hfl.make_cluster_train_step``).

Payload accounting (``HFLConfig.payload_accounting``): ``analytic`` prices
every transfer with the paper's ``Q·(1-φ)·bits_per_param``; ``measured``
prices the fronthaul with the byte-accurate codec streams of the REAL
sync payloads (``comm.make_sync_probe`` on scratch copies, before the
in-place sync), the access links with the codec on synthetic exact-k
payloads, and a per-link ``PayloadLedger`` lands in the trace meta.

Not ported yet (raise, naming their ROADMAP item): the ``async``
discipline (``_run_async``, Queue 1 item 12), depth > 2 hierarchies
(``_run_units``, item 13), data residency and oversubscribed fleets
(item 12) and telemetry (item 14).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from repro_torch.comm.accounting import warn_index_bits_deprecated
from repro_torch.comm.codecs import get_codec
from repro_torch.configs.base import HFLConfig, SimConfig
from repro_torch.obs.telemetry import make_telemetry
from repro_torch.sim.devices import DeviceFleet
from repro_torch.sim.selection import make_selector
from repro_torch.utils.tree import tree_leaves, tree_map
from repro_torch.wireless.latency import (
    LatencyParams, fl_latency, fl_latency_single, hfl_latency,
    hfl_latency_single,
)
from repro_torch.wireless.subcarrier import reallocate_after_drop
from repro_torch.wireless.topology import HCNTopology


# ---------------------------------------------------------------------------
# Trace
# ---------------------------------------------------------------------------


@dataclass
class Trace:
    """Deterministic wall-clock-vs-training record of one simulation run."""

    meta: dict = field(default_factory=dict)
    rows: list = field(default_factory=list)

    def add(self, **row) -> None:
        self.rows.append(row)

    @property
    def wallclock(self) -> float:
        return self.rows[-1]["t"] if self.rows else 0.0

    def to_json(self) -> dict:
        return {"meta": self.meta, "rows": self.rows}


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------


class SimEngine:
    """Drives (train_step, sync_step) under a scenario's wall clock (the
    reference's null-wireless mode, which adapted ``core.schedule.run_hfl``,
    has no counterpart: the port's ``run_hfl`` is its own plain loop)."""

    def __init__(
        self,
        *,
        period: int,
        hfl_cfg: HFLConfig,
        sim_cfg: SimConfig,
        topo: HCNTopology,
        fleet: DeviceFleet,
        lp: LatencyParams,
    ):
        self.period = int(period)
        self.hfl = hfl_cfg
        self.sim = sim_cfg
        self.obs = make_telemetry(sim_cfg.obs)  # raises for an enabled config
        if len(hfl_cfg.tiers) > 2:
            raise NotImplementedError(
                "depth > 2 hierarchies in the simulator (_run_units) are not "
                "ported yet: ROADMAP Queue 1 item 13")
        self.topo, self.fleet, self.lp = topo, fleet, lp
        slots = hfl_cfg.num_clusters * hfl_cfg.mus_per_cluster
        if fleet.K > slots:
            raise NotImplementedError(
                "oversubscribed fleets (K > num_clusters * mus_per_cluster) "
                "need the residency tracker, not ported yet: ROADMAP Queue 1 "
                "item 12")
        assert fleet.K == slots
        if self.sim.rate_model == "maxmin" and fleet.K > lp.M:
            raise ValueError(
                f"rate_model='maxmin' (Alg. 2) needs M >= K sub-carriers "
                f"but M={lp.M} < K={fleet.K}; use rate_model='single' "
                f"for fleet-scale runs")
        if self.sim.rate_model not in ("maxmin", "single"):
            raise ValueError(f"unknown rate_model {self.sim.rate_model!r}")
        self._aux = None  # cached hfl_latency aux for the current positions
        self._move_accum = 0.0  # virtual s of motion deferred by the
        #                         reprice_interval_s throttle
        self._vt = 0.0  # current virtual time (diurnal availability clock)
        self._train_launches = 0
        self._sync_launches = 0
        self._bits_access = 0.0
        self._bits_fronthaul = 0.0
        self._acc = hfl_cfg.payload_accounting
        if self._acc not in ("analytic", "measured"):
            raise ValueError(f"unknown payload_accounting {self._acc!r}")
        # client selection (sim.selection): None = the identity (prate >= 1,
        # uniform), and then no selector RNG stream is created
        self.selector = make_selector(hfl_cfg, self.sim)
        self._codec = None
        self.ledger = None
        self._probe = None
        self._ab = None  # static per-link access bits (synthetic payloads)
        if self._acc == "measured":
            self._codec = get_codec(self.hfl.codec)
        warn_index_bits_deprecated(self.lp)

    # --- public entry ----------------------------------------------------

    def run(
        self,
        state,
        train_step: Callable,
        sync_step: Callable,
        batches: Iterable,
        num_steps: int,
        on_step: Optional[Callable] = None,
    ):
        """-> (final_state, Trace). Deterministic in (scenario, seed) for a
        FRESH engine: the fleet RNG and positions advance across calls.

        ``train_step(state, batch, keep=None)`` is the port's
        ``make_cluster_train_step``: ``keep`` (bool [N]) is passed when
        clusters sat the round out. The discipline is the fleet-wide
        ``SimConfig.discipline``, as in the reference's depth-2 runs
        (``_tier_disciplines``: per-tier ``TierConfig.discipline`` entries
        act at depth > 2 only)."""
        disc = self.sim.discipline
        if disc not in ("lockstep", "deadline", "async"):
            raise ValueError(f"unknown discipline {disc!r}")
        if disc == "async":
            raise NotImplementedError(
                "the async discipline (_run_async, make_async_sync_step, "
                "the masked train step) is not ported yet: ROADMAP Queue 1 "
                "item 12")
        self._train_launches = 0
        self._sync_launches = 0
        self._bits_access = 0.0
        self._bits_fronthaul = 0.0
        self._setup_measured(state)
        return self._run_lockstep(
            state, train_step, sync_step, batches, num_steps, on_step,
            deadline=disc == "deadline",
        )

    # --- wireless plumbing -----------------------------------------------

    def _setup_measured(self, state) -> None:
        """Size the ledger/probe to the run's real flat model length."""
        if self._acc != "measured":
            return
        from repro_torch.comm import accounting as acct
        from repro_torch.core.hfl import wire_format_of
        from repro_torch.utils import flatten as fl

        if self.hfl.sync_mode != "dense" \
                and getattr(self.hfl, "sync_layout", "flat") != "flat":
            raise ValueError(
                "payload_accounting='measured' requires sync_layout='flat' "
                "(the probe measures the whole-model payloads)")
        wire = wire_format_of(self.hfl) or "f32"
        vf = getattr(self._codec, "value_format", None)
        if vf is not None and vf != "mixed" and vf != wire:
            import warnings

            warnings.warn(
                f"codec {self._codec.name!r} carries {vf} values but the "
                f"sync's wire format is {wire}: measured bits price a "
                f"fidelity the simulation does not exchange", stacklevel=2)
        Q = fl.spec_of(state.w_ref).total
        self.ledger = acct.PayloadLedger(
            codec=self._codec.name, size=Q, links=acct.link_names(2))
        self._probe = acct.make_sync_probe(self.hfl, self._codec)
        self._ab = {"dense": acct.access_bits("dense-f32", Q, 0.0)}
        for ti, tc in enumerate(self.hfl.tiers):
            ul_l, dl_l = acct.boundary_links(ti)
            self._ab[ul_l] = acct.access_bits(self._codec, Q, tc.phi_up)
            self._ab[dl_l] = acct.access_bits(self._codec, Q, tc.phi_down)
        self._aux = None  # re-price the radio with measured payloads

    def _probe_host(self, state):
        """The probe's bits of the sync about to run -> (sbs_ul float64 [N],
        mbs_dl float): the device counts come to the host in ONE copy."""
        ul, dl = self._probe(state)
        if torch.is_tensor(ul):
            counts = torch.cat([ul.reshape(-1), dl.reshape(1)]).cpu().numpy()
            ul, dl = counts[:-1], counts[-1]
        return np.asarray(ul, np.float64), float(dl)

    def _payload_overrides(self):
        """Static measured per-link bits for the analytic-formula slots
        (the per-event fronthaul θ is re-priced from ACTUAL probe bits)."""
        if self.ledger is None:
            return None
        return {k: float(self._ab[k])
                for k in ("mu_ul", "sbs_dl", "sbs_ul", "mbs_dl")}

    def _price_hfl(self):
        """(per_iter, aux) under the configured rate model: exact max-min
        allocation (``maxmin``, the paper's Alg. 2) or the fleet-scale
        shared-single-subcarrier model (``single``, any K)."""
        fn = (hfl_latency_single if self.sim.rate_model == "single"
              else hfl_latency)
        return fn(
            self.topo, self.fleet.pos, self.fleet.cid, self.lp,
            H=self.period,
            phi_mu_ul=self.hfl.tiers[0].phi_up, phi_sbs_dl=self.hfl.tiers[0].phi_down,
            phi_sbs_ul=self.hfl.tiers[1].phi_up, phi_mbs_dl=self.hfl.tiers[1].phi_down,
            reuse=self.sim.reuse,
            payload_bits=self._payload_overrides(),
        )

    def _latency_aux(self) -> dict:
        if self._aux is None:
            _, self._aux = self._price_hfl()
        return self._aux

    def _meta(self) -> dict:
        meta = {
            "scenario": self.sim.scenario,
            "discipline": self.sim.discipline,
            "seed": self.sim.seed,
            "period": self.period,
            "payload_accounting": self._acc,
            "residency": "static",
        }
        if self.ledger is not None:
            meta["codec"] = self.ledger.codec
            meta["payload_size"] = self.ledger.size
        comp_max = float(
            self.sim.base_compute_s * self.fleet.compute_mult.max())
        pb = self._payload_overrides()
        fl_fn = (fl_latency_single if self.sim.rate_model == "single"
                 else fl_latency)
        t_fl, _ = fl_fn(
            self.topo, self.fleet.pos, self.lp,
            phi_ul=self.hfl.tiers[0].phi_up, phi_dl=self.hfl.tiers[1].phi_down,
            ul_bits=None if pb is None else pb["mu_ul"],
            dl_bits=None if pb is None else pb["mbs_dl"],
        )
        per_iter, aux = self._price_hfl()
        self._aux = aux
        meta.update(
            wireless=True,
            t_fl_iter_s=t_fl + comp_max,
            t_hfl_iter_s=per_iter + comp_max,
            t_hfl_period_s=self.period * (per_iter + comp_max),
        )
        return meta

    def _round_ctx(self, deadline: bool) -> dict:
        """Latency/participation context for ONE upcoming H-period round,
        vectorized over the flat [K] fleet state with the reference's
        expressions (bit-identical values); only the Alg. 2 sub-carrier
        reclamation is a per-affected-cluster loop, skipped under
        ``rate_model='single'``."""
        hfl, lp, H = self.hfl, self.lp, self.period
        aux = self._latency_aux()
        cid = self.fleet.cid
        comp = self.fleet.compute_times(self.sim.base_compute_s)
        avail = self.fleet.draw_available(self._vt)
        fault = getattr(self.sim, "fault_dead_cluster", None)
        if fault is not None:
            # after the RNG draw: every other cluster's trajectory is
            # untouched, the faulted cluster's members never come up
            avail = avail & (cid != fault)
        if self.selector is not None:
            # the selector only shrinks the mask, from its own RNG stream
            avail = self.selector.select(avail, self.fleet, self._vt)
        N = hfl.num_clusters
        ul_pay = (float(self._ab["mu_ul"]) if self.ledger is not None
                  else lp.payload(hfl.tiers[0].phi_up))

        # per-MU round time: H iterations of own compute + own UL + cluster DL
        rate_flat = aux["mu_rate_flat"]
        r = H * (comp + ul_pay / rate_flat + aux["gamma_dl"][cid])

        mask = avail.copy()
        deadline_s = None
        if deadline and self.sim.deadline_factor > 0:
            finite = r[np.isfinite(r)]
            deadline_s = self.sim.deadline_factor * float(np.median(finite))
            mask &= r <= deadline_s

        # cluster iteration time over the SURVIVING MUs only
        sizes = self.fleet.cluster_sizes()
        surv = np.bincount(cid[mask], minlength=N)
        min_rate = np.full(N, np.inf)
        np.minimum.at(min_rate, cid[mask], rate_flat[mask])
        comp_term = np.full(N, -np.inf)
        np.maximum.at(comp_term, cid[mask], comp[mask])
        if self.sim.rate_model != "single":
            # a dropped/unavailable MU's sub-carriers are reclaimed: re-run
            # the max-min allocation (Alg. 2) over each AFFECTED cluster's
            # survivors with the cluster's full budget
            affected = np.nonzero((surv > 0) & (surv < sizes))[0]
            if affected.size:
                for n in affected:
                    members = self.fleet.cluster_members(n)
                    d = self.topo.dist_to_sbs(
                        self.fleet.pos[members], cid[members])
                    rates = reallocate_after_drop(
                        d, mask[members], aux["m_cluster"],
                        B0=lp.B0, Pmax=lp.p_mu, N0=lp.n0,
                        alpha=lp.alpha, ber=lp.ber)
                    min_rate[n] = rates[mask[members]].min()
        it_n = np.where(
            surv > 0, ul_pay / min_rate + aux["gamma_dl"] + comp_term, 0.0)
        iter_s = float(it_n.max()) if it_n.max() > 0 else self.sim.base_compute_s
        sync_s = float(aux["theta_u"] + aux["theta_d"] + aux["gamma_dl"].max())

        # static data layout: MU k trains in cluster k // mus_per_cluster
        keep_clusters = mask.reshape(N, hfl.mus_per_cluster).any(axis=1)
        return dict(
            iter_s=iter_s, sync_s=sync_s,
            mask=None if mask.all() else mask,
            keep_clusters=None if keep_clusters.all() else keep_clusters,
            dropped=int((~mask).sum()),
            participants=int(mask.sum()),
            deadline_s=deadline_s,
        )

    def _advance_fleet(self, dt: float) -> None:
        """Advance positions (waypoint integration), re-associate to the
        nearest SBS and invalidate the cached radio pricing. With
        ``sim.reprice_interval_s > 0`` motion is batched until the
        interval elapses (distance travelled is conserved)."""
        if not self.fleet.mobile:
            return
        if self.sim.reprice_interval_s > 0:
            self._move_accum += dt
            if self._move_accum < self.sim.reprice_interval_s:
                return
            dt, self._move_accum = self._move_accum, 0.0
        self.fleet.advance(dt)
        self.fleet.reassociate()
        self._aux = None  # positions changed: re-price the radio

    def _apply_participation(self, batch, mask: Optional[np.ndarray]):
        """Resample dropped MUs' batch rows from their cluster's survivors.
        The row index is the reference's, built on the host; the rows are
        gathered on the batch's device in one indexing op per leaf."""
        if mask is None:
            return batch
        N, mpc = self.hfl.num_clusters, self.hfl.mus_per_cluster
        leaves = tree_leaves(batch)
        if not leaves or leaves[0].ndim < 2:
            return batch
        localB = leaves[0].shape[1]
        if localB % mpc:
            return batch  # unknown row layout; leave the batch untouched
        bpm = localB // mpc
        idx = np.tile(np.arange(localB)[None], (N, 1))
        for n in range(N):
            kept = [j for j in range(mpc) if mask[n * mpc + j]]
            if not kept or len(kept) == mpc:
                continue
            src = [kept[j % len(kept)] for j in range(mpc)]
            idx[n] = np.concatenate(
                [np.arange(s * bpm, (s + 1) * bpm) for s in src]
            )
        idx_t = torch.from_numpy(idx).to(leaves[0].device)
        rowsel = torch.arange(N, device=idx_t.device)[:, None]
        return tree_map(lambda leaf: leaf[rowsel, idx_t] if leaf.ndim >= 2
                        else leaf, batch)

    # --- byte accounting --------------------------------------------------

    def _count_train(self, participants: int, clusters: int):
        """-> ``(ul_bits, dl_bits)`` charged to the access links this
        launch."""
        self._train_launches += 1
        p = participants
        if self.ledger is not None:
            # measured mode charges the codec on synthetic exact-k payloads
            ul = self.ledger.record("mu_ul", p * self._ab["mu_ul"], events=p)
            dl = self.ledger.record(
                "sbs_dl", clusters * self._ab["sbs_dl"], events=clusters
            )
        else:
            lp, hfl = self.lp, self.hfl
            ul = p * lp.payload(hfl.tiers[0].phi_up)
            dl = clusters * lp.payload(hfl.tiers[0].phi_down)
        self._bits_access += ul + dl
        return ul, dl

    def _count_sync(self, clusters: int):
        """Analytic fronthaul charge -> ``(ul_bits, dl_bits)``."""
        self._sync_launches += 1
        lp, hfl = self.lp, self.hfl
        ul = clusters * lp.payload(hfl.tiers[1].phi_up)
        dl = lp.payload(hfl.tiers[1].phi_down)
        self._bits_fronthaul += ul + dl
        return ul, dl

    def _count_sync_measured(self, ul_bits, dl_bits: float):
        """Record the REAL fronthaul payload bits of one sync event
        -> the ledger's recorded ``(ul_bits, dl_bits)`` floats."""
        self._sync_launches += 1
        ul_bits = np.atleast_1d(np.asarray(ul_bits, np.float64))
        ul = self.ledger.record("sbs_ul", float(ul_bits.sum()),
                                events=len(ul_bits))
        dl = self.ledger.record("mbs_dl", float(dl_bits))
        self._bits_fronthaul += ul + dl
        return ul, dl

    def _totals(self) -> dict:
        out = {
            "train_launches": self._train_launches,
            "sync_launches": self._sync_launches,
            "bits_access_total": self._bits_access,
            "bits_fronthaul_total": self._bits_fronthaul,
        }
        if self.ledger is not None:
            out.update(self.ledger.summary())
        return out

    # --- lockstep / deadline ---------------------------------------------

    def _run_lockstep(
        self, state, train_step, sync_step, batches, num_steps, on_step,
        *, deadline: bool,
    ):
        H = self.period
        it = iter(batches)
        trace = Trace(meta=self._meta())
        t = 0.0
        ctx: dict = {}
        N = self.hfl.num_clusters
        for step in range(num_steps):
            if step % H == 0:
                # the virtual clock feeds the diurnal availability curve
                self._vt = t
                ctx = self._round_ctx(deadline)
            batch = self._apply_participation(next(it), ctx["mask"])
            keep = ctx["keep_clusters"]
            if keep is not None:  # sat-out clusters: loss only, no update
                state, loss = train_step(state, batch, keep=keep)
            else:
                state, loss = train_step(state, batch)
            t += ctx["iter_s"]
            self._count_train(ctx["participants"], N)
            trace.add(kind="train", t=t, step=step,
                      loss=float(loss.float().mean()), dropped=ctx["dropped"])
            if (step + 1) % H == 0:
                sync_s = ctx["sync_s"]
                row_extra = {}
                if self.ledger is not None:
                    # measure the REAL fronthaul payloads this sync sends
                    # (before the in-place sync consumes the state) and
                    # re-price θ^U/θ^D from the actual bit counts
                    ul_b, dl_b = self._probe_host(state)
                    self._count_sync_measured(ul_b, dl_b)
                    aux = self._latency_aux()
                    # the post-consensus SBS->MU broadcast carries the
                    # ACTUAL consensus payload (dl_b bits): re-price each
                    # cluster's broadcast leg from its realized DL rate;
                    # clusters mobility has emptied (dl_rate=inf) are
                    # charged neither time nor bits
                    finite = np.isfinite(aux["dl_rates"])
                    t_bcast = np.where(finite, dl_b / aux["dl_rates"], 0.0)
                    n_bcast = int(finite.sum())
                    if n_bcast:
                        self._bits_access += self.ledger.record(
                            "sbs_dl", n_bcast * dl_b, events=n_bcast)
                    sync_s = float(
                        (ul_b.max() + dl_b) / aux["fh_rate"]
                        + (t_bcast[finite].max() if n_bcast else 0.0)
                    )
                    row_extra = {"bits_sbs_ul": float(ul_b.sum()),
                                 "bits_mbs_dl": dl_b,
                                 "bits_sync_bcast": n_bcast * dl_b}
                else:
                    self._count_sync(N)
                state = sync_step(state)
                t += sync_s
                trace.add(kind="sync", t=t, step=step, dropped=ctx["dropped"],
                          deadline_s=ctx["deadline_s"], iter_s=ctx["iter_s"],
                          sync_s=sync_s, **row_extra)
                self._advance_fleet(H * ctx["iter_s"] + sync_s)
            if on_step is not None:
                on_step(step, state, loss)
        trace.meta.update(self._totals())
        return state, trace
