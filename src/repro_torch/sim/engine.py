"""Simulation engine: wall-clock scenario runs of the real training loop
(the port of ``repro.sim.engine``: every discipline, every depth).

Couples three layers:

  * the wireless model (``repro_torch.wireless.latency``) — per-cluster
    UL/DL times, fronthaul, frequency reuse — evaluated against the fleet's
    *current* positions each round, so mobility changes the time axis;
  * the device runtime model (``repro_torch.sim.devices``) — per-MU
    compute times, availability, mobility (the waypoint integrator or a
    replayed ``sim.traces.MobilityTrace``);
  * the *real* training loop (``core.hfl.make_cluster_train_step`` /
    ``make_masked_cluster_train_step`` / ``make_sync`` and this module's
    ``make_async_sync_step``) on the card — the accuracy axis is produced
    by actual SGD on actual models, not a convergence proxy.

Time is virtual: the clock, the fleet and the pricing are the reference's
numpy code with the reference's RNG streams and draw order, so a run's
timeline (every trace row's ``t``, ``iter_s``, ``sync_s``, ``dropped``,
``deadline_s``, ``staleness``, ``weight``, ``bits_*``) is bit-identical to
the reference's for the same (scenario, seed). No torch RNG enters it.

Three sync disciplines (``SimConfig.discipline``):

  * ``lockstep`` — the paper's schedule: every cluster runs H intra-cluster
    iterations, the MBS consensus happens when the slowest cluster arrives
    (Γ^period = H·max_n Γ_n + Θ^U + Θ^D, eq. 21).
  * ``deadline`` — straggler drop: each round has a deadline
    (``deadline_factor`` × median per-MU round time); MUs that would finish
    late are dropped for the round (their batch rows are resampled from the
    participants) and the round completes at the slowest surviving MU.
  * ``async`` — clusters sync with the MBS on their own clocks (an event
    queue of per-cluster round completions); each event trains ONE cluster
    H iterations (the masked train step) and applies its contribution with
    a staleness-discounted weight (``async_weight``), dense or sparse
    (per-cluster ``e_dl``) downlink.

A cluster with no participant sits the round out: its params and
optimizer rows stay bitwise as they were, while ``step`` advances and its
loss still counts in the row's mean, as in the reference (whose vmapped
step computes every cluster and ``_merge_clusters`` restores the sat-out
rows). The port's train step updates in place, so the engine passes the
``keep`` mask to it and the step computes a sat-out cluster's loss with no
update (``core.hfl.make_cluster_train_step``).

Data residency (``data.federated.ResidencyTracker``): by default MU k
always trains in cluster ``k // mus_per_cluster``; with a tracker, each
re-association remaps shards under a policy (``move``/``duplicate``/
``stale``) and the engine gathers every cluster's batch rows from its
resident MUs' data slots (``duplicate`` weights a replicated shard's rows
``1/n_copies`` through the loss's ``row_weight``). Oversubscribed fleets
(``fleet_mus_per_cluster``, up to the 1.05M MUs of ``scale-1m``) need a
tracker: each round subsamples the resident shards into the training
slots.

Payload accounting (``HFLConfig.payload_accounting``): ``analytic`` prices
every transfer with the paper's ``Q·(1-φ)·bits_per_param``; ``measured``
prices the fronthaul with the byte-accurate codec streams of the REAL
sync payloads (``comm.make_sync_probe`` on scratch copies before the
in-place lockstep sync; the async sync's own device counts), the access
links with the codec on synthetic exact-k payloads, and a per-link
``PayloadLedger`` lands in the trace meta.

Depth > 2 (a ``core.hfl.HierSyncStep``, detected by its ``hier``
attribute): the engine threads the tier buffers and fires the highest
boundary whose cadence is due (``hier_fire_top``), pricing every
boundary's fronthaul (analytic per tier, or the hier probe's measured
payloads on per-boundary ledger links); per-tier ``TierConfig.
discipline`` entries resolve to a ``deadline`` boundary 1 and an async
top suffix (``_tier_disciplines``), whose units run on their own clocks
(``_run_units``: within-unit cascades and staleness-weighted pushes).

Without ``topo``/``fleet``/``lp`` the engine runs in null-wireless mode:
unit virtual time per iteration and no comms time, which is how
``core.schedule.run_hfl`` drives an async-root tree (``record=False``
keeps no trace rows).

Telemetry (``repro_torch.obs``, ``SimEngine(obs=...)`` or
``SimConfig.obs``) is the reference's, emit site for emit site: virtual-
clock spans of every iteration, phase, payload, sync, idle round and
repricing (each ledger record mirrored by one ``link_span`` with the same
float, so span/ledger conservation is exact at teardown), the ``sim.*``
registry totals and fairness gauges, and the learning-health monitor's
loss, round, sync-statistics and churn signals. Host-clock spans wrap the
same step calls as the reference's: on the card a call returns once its
kernels are queued, so a span measures dispatch unless the call waits on
the card (a loss or a bit count copied to the host), as a jit dispatch
does under JAX. Telemetry only reads the run: the state, the RNG streams
and the virtual clock are the same with it on or off.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from repro_torch.comm.accounting import boundary_links, warn_index_bits_deprecated
from repro_torch.comm.codecs import get_codec
from repro_torch.configs.base import HFLConfig, SimConfig
from repro_torch.obs.telemetry import make_telemetry
from repro_torch.sim.devices import DeviceFleet
from repro_torch.sim.events import Event, EventQueue
from repro_torch.sim.selection import make_selector
from repro_torch.utils.fp import axpy_, fma_f32
from repro_torch.utils.tree import tree_leaves, tree_map
from repro_torch.wireless.latency import (
    LatencyParams, fl_latency, fl_latency_single, hfl_latency,
    hfl_latency_single, tier_payload_bits,
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
    record: bool = field(default=True, repr=False)  # False: keep no rows

    def add(self, **row) -> None:
        if self.record:
            self.rows.append(row)

    @property
    def wallclock(self) -> float:
        return self.rows[-1]["t"] if self.rows else 0.0

    def to_json(self) -> dict:
        return {"meta": self.meta, "rows": self.rows}


def _wait(x) -> None:
    """Wait for the card when ``x`` (a tensor or a tree) lives on one."""
    t = x if torch.is_tensor(x) else tree_leaves(x.w_ref)[0]
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


# ---------------------------------------------------------------------------
# Async staleness-weighted consensus
# ---------------------------------------------------------------------------


def async_weight(staleness: int, num_clusters: int, exp: float = 1.0) -> float:
    """MBS application weight of one cluster's async contribution.

    ``1/N`` matches the lockstep mean when every cluster arrives fresh;
    the ``(1+s)^-exp`` discount shrinks contributions computed against a
    reference that ``s`` other syncs have since moved.
    """
    return (1.0 / num_clusters) * (1.0 + float(staleness)) ** (-float(exp))


def _norm(x):
    return torch.linalg.vector_norm(x.double()).float()


def _scatter_row_(params, n: int, spec, idx, fn) -> None:
    """Row n of the stacked params at the flat positions ``idx`` (int64,
    distinct) becomes ``fn(old values as f32, positions in idx)``, cast back
    to each leaf's dtype; the row's other entries are not touched. The
    positions are sorted once and split at the leaf offsets."""
    order = torch.argsort(idx)
    sidx = idx[order]
    edges = torch.tensor(spec.offsets + (spec.total,), device=idx.device)
    bounds = torch.searchsorted(sidx, edges).tolist()  # one host copy
    for i, P in enumerate(tree_leaves(params)):
        a, b = bounds[i], bounds[i + 1]
        if a == b:
            continue
        loc = sidx[a:b] - spec.offsets[i]
        row = P[n].view(-1)
        row[loc] = fn(row[loc].float(), order[a:b]).to(P.dtype)


def make_async_sync_step(
    hfl_cfg: HFLConfig, *, dl_sparse: bool = False, codec=None,
    collect_stats: bool = False, on_payloads: Optional[Callable] = None,
) -> Callable:
    """Per-cluster staleness-weighted sparse sync (the reference's
    ``make_async_sync_step``), IN PLACE on the state's buffers.

    The uplink is the paper's Ω of cluster n's drift (whole-model
    top-(1-φ), with the SBS error buffer, wire-rounded under
    ``quantized_sparse``); the MBS applies ``weight * sent`` instead of the
    lockstep mean. Downlink, two flavours:

      * dense (``dl_sparse=False``): the cluster adopts the fresh
        reference verbatim — ``(state, n, weight) -> state``;
      * sparse (``dl_sparse=True``): the MBS sends Ω of what the cluster
        is missing (``φ_mbs_dl``), buffered by the per-cluster downlink
        error ``e_dl [N, Q]`` (``init_dl_error``), which the caller threads
        through: ``(state, e_dl, n, weight) -> (state, e_dl)``.

    With ``codec`` set, each call also returns a dict of device bit counts
    (``measure_bits_torch``) of the payloads sent: ``{"sbs_ul": ...}``
    plus ``"mbs_dl"`` when the downlink is sparse. With ``collect_stats``
    it also returns (last) the health monitor's statistics of the cluster
    that synced, 0-d tensors and index sets on the state's device:
    ``drift`` (its row's consensus drift over the post-sync rows,
    ``core.hfl._drift_stats``), ``eps_norm``, ``wref_norm``, ``update_norm`` (of
    ``weight * sent``), ``ul_idx``, and with the sparse downlink
    ``e_dl_norm`` and ``dl_idx``; the state is the same with them on or
    off. ``on_payloads(n,
    uplink, downlink)`` (optional) receives each call's (values, indices)
    payloads, ``downlink`` None when dense.

    Memory: nothing of size [Q] beyond the state is allocated. The drift s
    is formed inside eps[n] and left there as s - sent; w_ref receives the
    k sent entries only; the downlink difference is formed inside
    e_dl[n] and left there as diff - recv; row n is written from w_ref
    (dense) or at the k received entries (sparse). The arithmetic is the
    reference's as XLA compiles it: fma(β_s, eps_n, w_n - w_ref),
    fma(weight, sent, w_ref) with ``weight`` rounded to f32 (the reference
    passes ``jnp.float32(w)``) and fma(β_m, e_dl_n, w_ref' - w_n), so a
    call is bitwise the reference's jitted step on the CPU.
    """
    from repro_torch.core import sparsify as sp
    from repro_torch.core.hfl import (
        _drift_stats, _pack_drift, _sync_buffers, _wire_round_rows,
        wire_format_of,
    )
    from repro_torch.utils import flatten as fl

    if isinstance(codec, str):
        codec = get_codec(codec)
    impl = hfl_cfg.omega_impl
    wire = wire_format_of(hfl_cfg)
    tier = hfl_cfg.tiers[1]
    N = hfl_cfg.num_clusters

    def payload(x, phi):
        vals, idx = sp.pack_phi(x, phi, impl=impl)
        if wire:
            # the residual buffers the wire error too (receivers only
            # ever see the rounded value)
            vals = _wire_round_rows(vals, wire)
        return vals, idx

    def core(state, e_dl, n, weight):
        n = int(n)
        w = float(np.float32(weight))
        wref, _e, eps, spec, eps_spec = _sync_buffers(state, N)
        Q = spec.total
        bits = {}
        # --- uplink (Alg. 5 l.24-27 for ONE cluster), s formed in eps[n]
        _pack_drift(eps, state.params, wref, tier.beta_up, spec, rows=(n,))
        s = eps[n]
        vals, idx = payload(s, tier.phi_up)
        if codec is not None:
            bits["sbs_ul"] = codec.measure_bits_torch(vals, idx, Q)
        up = idx.long()
        # --- MBS: the staleness-weighted application on the sent entries
        wref[up] = fma_f32(w, vals, wref[up])
        s.index_add_(0, up, -vals)  # eps_n = s - sent
        down = None
        if dl_sparse:
            # diff = fma(β_m, e_dl[n], w_ref' - w_n), formed in e_dl[n]
            d = e_dl[n]
            for i, P in enumerate(tree_leaves(state.params)):
                sl = spec.leaf_slice(i)
                diff = wref[sl] - P[n].reshape(-1).float()
                d[sl] = axpy_(diff, tier.beta_down, d[sl])
            dvals, didx = payload(d, tier.phi_down)
            if codec is not None:
                bits["mbs_dl"] = codec.measure_bits_torch(dvals, didx, Q)
            dn = didx.long()
            _scatter_row_(state.params, n, spec, dn,
                          lambda old, j: old + dvals[j])  # w_n + recv
            d.index_add_(0, dn, -dvals)  # e_dl[n] = diff - recv
            down = (dvals, didx)
        else:
            for i, P in enumerate(tree_leaves(state.params)):
                P[n].copy_(wref[spec.leaf_slice(i)].reshape(P.shape[1:]))
        if on_payloads is not None:
            on_payloads(n, (vals, idx), down)
        stats = None
        if collect_stats:
            # read-only over the buffers the sync just wrote
            stats = {"drift": _drift_stats(state.params)[0][n],
                     "eps_norm": _norm(s), "wref_norm": _norm(wref),
                     "update_norm": _norm(vals * w), "ul_idx": idx}
            if dl_sparse:
                stats["e_dl_norm"] = _norm(e_dl[n])
                stats["dl_idx"] = down[1]
        state = state._replace(w_ref=fl.unpack(wref, spec),
                               eps=fl.unpack_stacked(eps, eps_spec))
        return state, e_dl, bits, stats

    def extras(bits, stats):  # (bits?, stats?) after the carried state
        return (((bits,) if codec is not None else ())
                + ((stats,) if collect_stats else ()))

    if dl_sparse:

        def async_sync_dl(state, e_dl, n, weight):
            state, e_dl, bits, stats = core(state, e_dl, n, weight)
            return (state, e_dl) + extras(bits, stats)

        async_sync_dl.collect_stats = collect_stats
        return async_sync_dl

    def async_sync(state, n, weight):
        state, _, bits, stats = core(state, None, n, weight)
        out = extras(bits, stats)
        return (state,) + out if out else state

    async_sync.collect_stats = collect_stats
    return async_sync


def init_dl_error(state, hfl_cfg: HFLConfig):
    """Zero per-cluster downlink error buffer [N, Q] for the sparse-DL
    async sync (flat layout, same offsets as the packed ``w_ref``), on the
    state's device."""
    from repro_torch.utils import flatten as fl

    Q = fl.spec_of(state.w_ref).total
    dev = tree_leaves(state.w_ref)[0].device
    return torch.zeros((hfl_cfg.num_clusters, Q), dtype=torch.float32,
                       device=dev)


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------


class SimEngine:
    """Drives (train_step, sync_step) under a scenario's wall clock. With
    ``topo``/``fleet``/``lp`` unset it runs in null-wireless mode (unit
    virtual time per iteration, zero comms time), as ``core.schedule.
    run_hfl`` does for an async-root tree; ``record=False`` keeps no
    trace rows. ``obs`` (a telemetry handle) wins over ``SimConfig.obs``:
    callers sharing one tracer across runs pass it."""

    def __init__(
        self,
        *,
        period: int,
        hfl_cfg: Optional[HFLConfig] = None,
        sim_cfg: Optional[SimConfig] = None,
        topo: Optional[HCNTopology] = None,
        fleet: Optional[DeviceFleet] = None,
        lp: Optional[LatencyParams] = None,
        record: bool = True,
        residency=None,
        obs=None,
    ):
        self._record = record
        self.period = int(period)
        self.hfl = hfl_cfg
        self.sim = sim_cfg if sim_cfg is not None else SimConfig()
        # telemetry: an explicit handle wins, else SimConfig.obs; the
        # default is the shared NULL_TELEMETRY, whose ``enabled`` flag
        # guards every emit site
        self.obs = obs if obs is not None else make_telemetry(self.sim.obs)
        self.topo, self.fleet, self.lp = topo, fleet, lp
        self.wireless = topo is not None and fleet is not None and lp is not None
        # oversubscribed fleets: more physical MUs than training slots
        # (SimConfig.fleet_mus_per_cluster > hfl.mus_per_cluster). Each
        # round subsamples the resident shards into the slots, so batches
        # stay [N, localB] while pricing/availability run fleet-wide.
        self._oversub = False
        if self.wireless:
            assert hfl_cfg is not None, "wireless simulation needs hfl_cfg"
            slots = hfl_cfg.num_clusters * hfl_cfg.mus_per_cluster
            self._oversub = fleet.K > slots
            if self._oversub:
                assert residency is not None, (
                    "an oversubscribed fleet (K > num_clusters * "
                    "mus_per_cluster) needs a residency tracker to pick "
                    "which resident shards fill the training slots")
            else:
                assert fleet.K == slots
            if self.sim.rate_model == "maxmin" and fleet.K > lp.M:
                raise ValueError(
                    f"rate_model='maxmin' (Alg. 2) needs M >= K sub-carriers "
                    f"but M={lp.M} < K={fleet.K}; use rate_model='single' "
                    f"for fleet-scale runs")
            if self.sim.rate_model not in ("maxmin", "single"):
                raise ValueError(
                    f"unknown rate_model {self.sim.rate_model!r}")
        # data residency tracker (data.federated.ResidencyTracker): when
        # set, batch rows follow the resident shards instead of the static
        # slot layout. None = static residency.
        self.residency = residency
        self._slot_rot = 0  # per-round rotation of the resident selection
        if residency is not None:
            assert residency.K == fleet.K and \
                residency.N == hfl_cfg.num_clusters
        self._aux = None  # cached hfl_latency aux for the current positions
        self._crt = None  # cached per-cluster round times (same lifetime)
        self._move_accum = 0.0  # virtual s of motion deferred by the
        #                         reprice_interval_s throttle
        self._vt = 0.0  # current virtual time (diurnal availability clock)
        self._train_launches = 0
        self._sync_launches = 0
        self._bits_access = 0.0
        self._bits_fronthaul = 0.0
        # fleet-health bookkeeping (obs on only): per-cluster rounds seen /
        # rounds contributed, feeding sim.participation_rate and the
        # drop-fairness Gini at _finish_run
        self._rounds_part = None
        self._rounds_seen = None
        self._acc = (hfl_cfg.payload_accounting if hfl_cfg is not None
                     else "analytic")
        if self._acc not in ("analytic", "measured"):
            raise ValueError(f"unknown payload_accounting {self._acc!r}")
        # client selection (sim.selection): None = the identity (prate >= 1,
        # uniform), and then no selector RNG stream is created
        self.selector = (make_selector(hfl_cfg, self.sim) if self.wireless
                         else None)
        self._codec = None
        self.ledger = None
        self._probe = None
        self._ab = None  # static per-link access bits (synthetic payloads)
        if self._acc == "measured":
            self._codec = get_codec(self.hfl.codec)
        if self.wireless:
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
        masked_train_step: Optional[Callable] = None,
        on_async_sync: Optional[Callable] = None,
    ):
        """-> (final_state, Trace). Deterministic in (scenario, seed) for a
        FRESH engine: the fleet RNG and positions advance across calls.

        ``train_step(state, batch, keep=None)`` is the port's
        ``make_cluster_train_step``: ``keep`` (bool [N]) is passed when
        clusters sat the round out. The disciplines come from
        ``_tier_disciplines``: the fleet-wide ``SimConfig.discipline`` at
        depth 2, per-tier ``TierConfig.discipline`` entries at depth > 2.
        A tiered ``sync_step`` (``core.hfl.HierSyncStep``, its ``hier``
        attribute set) is called ``sync_step(state, bufs, top)`` on the
        buffers of its own ``init_bufs``; with an async top suffix its
        ``unit_ops`` drive ``_run_units``, which reports each unit sync
        and push to ``on_async_sync`` (``kind`` "unit_sync" or "push",
        ``unit``, ``tier``, ``agg``, ``round``, ``seconds`` and, for a
        push, ``staleness`` and ``weight``).

        Under depth-2 ``async`` ``sync_step`` is unused: the engine builds the
        staleness-weighted per-cluster sync (``make_async_sync_step``).
        ``masked_train_step(state, batch_n, n)``
        (``core.hfl.make_masked_cluster_train_step``) trains only the
        event's cluster; without it ``train_step(keep=one-hot n)`` does,
        computing every cluster's loss. ``on_async_sync(event, state)`` is
        called after each event's sync with ``event`` a dict: ``index``,
        ``cluster``, ``round``, ``staleness``, ``weight`` (the f32 the MBS
        applied), ``seconds`` (the sync's wall time, the device waited on
        before and after), ``bits_sbs_ul``/``bits_mbs_dl`` (the fronthaul
        bits charged for it, the ledger's records under measured
        accounting) and the ``uplink``/``downlink`` (values, indices)
        payloads it sent (``downlink`` None when dense), alive for the call
        only."""
        self._train_launches = 0
        self._sync_launches = 0
        self._bits_access = 0.0
        self._bits_fronthaul = 0.0
        self._slot_rot = 0
        if self.obs.enabled and self.hfl is not None:
            n_cl = self.hfl.num_clusters
            self._rounds_part = np.zeros(n_cl, np.int64)
            self._rounds_seen = np.zeros(n_cl, np.int64)
        else:
            self._rounds_part = self._rounds_seen = None
        self.obs.reset_run()
        hier = bool(getattr(sync_step, "hier", False))
        if hier and self.hfl is None:
            # null-wireless (core.schedule.run_hfl): the tiered sync's own
            # config describes the hierarchy
            self.hfl = sync_step.cfg
        self._setup_measured(state)
        cut, deadline = self._tier_disciplines(hier)
        if cut is None:
            return self._run_lockstep(
                state, train_step, sync_step, batches, num_steps, on_step,
                deadline=deadline,
            )
        if not hier:
            return self._run_async(state, train_step, batches, num_steps,
                                   on_step, masked_train_step, on_async_sync)
        return self._run_units(state, train_step, sync_step, batches,
                               num_steps, on_step, on_async_sync, cut=cut)

    def _tier_disciplines(self, hier: bool):
        """Resolve the run's sync disciplines -> ``(cut, deadline)``:
        ``cut`` is the lowest ASYNC tier boundary (every boundary at or
        above it runs clock-free; None = a fully synchronous run) and
        ``deadline`` flags the boundary-1 per-MU straggler drop.

        At depth 2 the fleet-wide ``SimConfig.discipline`` decides. Deeper
        trees read the per-tier ``TierConfig.discipline`` entries; when
        they all keep the default lockstep, the fleet-wide knob maps onto
        the tree (``deadline`` onto boundary 1, ``async`` onto the top
        boundary). Async boundaries must form a contiguous top suffix,
        and ``deadline`` is boundary 1's only, below no async cut."""
        sim_disc = self.sim.discipline
        if sim_disc not in ("lockstep", "deadline", "async"):
            raise ValueError(f"unknown discipline {sim_disc!r}")
        if not hier:
            if sim_disc == "async":
                return 1, False
            return None, sim_disc == "deadline"
        d = [tc.discipline for tc in self.hfl.tiers[1:]]
        if all(x == "lockstep" for x in d) and sim_disc != "lockstep":
            if sim_disc == "deadline":
                d[0] = "deadline"
            else:
                d[-1] = "async"
        cut = None
        for i, x in enumerate(d):
            if x == "async":
                cut = i + 1
                break
        if cut is not None and any(x != "async" for x in d[cut - 1:]):
            raise ValueError(
                f"async tier boundaries must form a contiguous top suffix "
                f"of the tree (got disciplines {tuple(d)}): a synchronous "
                f"barrier cannot run above children on their own clocks")
        if any(x == "deadline" for x in d[1:]):
            raise ValueError(
                "the deadline discipline applies at tier boundary 1 only "
                "(the per-MU round deadline); higher boundaries are "
                "lockstep or async")
        deadline = d[0] == "deadline"
        if deadline and cut is not None:
            raise ValueError(
                "a deadline boundary below an async cut is not supported "
                "yet (the unit scheduler prices rounds without drops)")
        return cut, deadline

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
        depth = len(self.hfl.tiers)
        self.ledger = acct.PayloadLedger(
            codec=self._codec.name, size=Q, links=acct.link_names(depth),
            registry=self.obs.registry if self.obs.enabled else None)
        # depth 2 probes the flat sync, deeper trees the cascade's
        # per-boundary payloads (the same codec streams)
        self._probe = (acct.make_sync_probe(self.hfl, self._codec) if depth == 2
                       else acct.make_hier_sync_probe(self.hfl, self._codec))
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
            "residency": (self.residency.policy if self.residency is not None
                          else "static"),
        }
        if self.fleet is not None and self.fleet.trace is not None:
            meta["trace_replay"] = True
            meta["trace_duration_s"] = self.fleet.trace.duration
        if self.ledger is not None:
            meta["codec"] = self.ledger.codec
            meta["payload_size"] = self.ledger.size
        if not self.wireless:
            meta["wireless"] = False
            return meta
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
        if not self.wireless:
            return dict(iter_s=self.sim.base_compute_s, sync_s=0.0,
                        mask=None, keep_clusters=None, dropped=0,
                        participants=None, deadline_s=None)
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

        # residency-aware compute placement: the MUs whose shards train
        # this round (the slot sources) set each cluster's compute time
        src = None
        if self.residency is not None:
            src = self._slot_sources(None if mask.all() else mask)

        # cluster iteration time over the SURVIVING MUs only
        sizes = self.fleet.cluster_sizes()
        surv = np.bincount(cid[mask], minlength=N)
        min_rate = np.full(N, np.inf)
        np.minimum.at(min_rate, cid[mask], rate_flat[mask])
        if src is not None:
            # max is idempotent: duplicate slot sources reduce the same
            valid = src >= 0
            comp_src = np.where(valid, comp[np.where(valid, src, 0)], -np.inf)
            comp_term = np.where(valid.any(axis=1), comp_src.max(axis=1), 0.0)
        else:
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

        keep_clusters = None
        if not self._oversub:
            # static data layout: MU k trains in cluster k // mus_per_cluster
            keep_clusters = mask.reshape(N, hfl.mus_per_cluster).any(axis=1)
        ctx = dict(
            iter_s=iter_s, sync_s=sync_s,
            mask=None if mask.all() else mask,
            keep_clusters=(None if keep_clusters is None or keep_clusters.all()
                           else keep_clusters),
            dropped=int((~mask).sum()),
            participants=int(mask.sum()),
            deadline_s=deadline_s,
        )
        if self.obs.enabled:
            # per-cluster phase decomposition for the trace viz (time
            # only, clamped to surviving clusters; payload bits ride the
            # link spans, one per ledger record)
            with np.errstate(divide="ignore", invalid="ignore"):
                ctx["phases"] = {
                    "surv": surv,
                    "comp": np.where(surv > 0, comp_term, 0.0),
                    "ul": np.where(surv > 0, ul_pay / min_rate, 0.0),
                    "dl": np.where(surv > 0, aux["gamma_dl"], 0.0),
                }
        if src is not None:
            # accounting charges the DISTINCT shards that actually train
            ctx["src"] = src
            ctx["participants"] = int(sum(
                np.unique(row[row >= 0]).size for row in src))
            ctx["active_clusters"] = int((src[:, 0] >= 0).sum())
        return ctx

    def _advance_fleet(self, dt: float, now: Optional[float] = None) -> None:
        """Advance positions (waypoint integration or trace replay),
        re-associate to the nearest SBS, propagate the new association to
        the residency tracker and invalidate the cached radio pricing and
        round times. With ``sim.reprice_interval_s > 0`` motion is batched
        until the interval elapses (distance travelled is conserved).
        ``now`` is the virtual time of the triggering event: with telemetry
        on, each effective advance lands as a ``reprice`` instant on the
        fleet track carrying the covered motion and re-association
        count."""
        if self.fleet is None or not self.fleet.mobile:
            return
        if self.sim.reprice_interval_s > 0:
            self._move_accum += dt
            if self._move_accum < self.sim.reprice_interval_s:
                return
            dt, self._move_accum = self._move_accum, 0.0
        spans = self.obs.enabled and now is not None
        old_cid = self.fleet.cid.copy() if spans else None
        self.fleet.advance(dt)
        self.fleet.reassociate()
        if self.residency is not None:
            self.residency.update(self.fleet.cid)
        self._aux = None  # positions changed: re-price the radio
        self._crt = None  # per-cluster round times follow the pricing
        if spans:
            moved = int((self.fleet.cid != old_cid).sum())
            self.obs.tracer.instant(
                "reprice", track="fleet", t=now,
                args={"dt_s": dt, "reassociations": moved})
            self.obs.registry.counter("sim.reprices").inc()
            self.obs.registry.counter("sim.reassociations").inc(moved)
            self.obs.health.ingest_churn(moved, t=now)

    # --- data residency ---------------------------------------------------

    def _slot_sources(self, mask: Optional[np.ndarray]) -> np.ndarray:
        """Source MU id per (cluster, slot) under the residency map [N, mpc]
        (the reference's, bit-identical): slot ``(n, j)`` cycles over
        cluster ``n``'s available resident MUs, rotated per round; a ``-1``
        row marks a cluster with no available resident shard (it sits the
        round out)."""
        N, mpc = self.hfl.num_clusters, self.hfl.mus_per_cluster
        src = np.full((N, mpc), -1, np.int64)
        off = self._slot_rot
        self._slot_rot += 1
        cols, starts = self.residency.members_csr(mask)
        sizes = np.diff(starts)
        has = sizes > 0
        if has.any():
            idx = (np.arange(mpc)[None, :] + off * mpc) \
                % np.maximum(sizes, 1)[:, None]
            # gather only the non-empty rows (an empty cluster's start can
            # sit one past the end of cols)
            src[has] = cols[(starts[:-1, None] + idx)[has]]
        return src

    def _row_weight(self, w: np.ndarray, like):
        """Duplicate-policy row weights as an f32 tensor on ``like``'s
        device."""
        return torch.from_numpy(np.asarray(w, np.float32)).to(like.device)

    def _gather_batch(self, batch, src: np.ndarray):
        """Rebuild the [N, localB] batch so cluster ``n``'s rows come from
        its resident MUs' data slots (MU k's rows live at
        ``[k // mpc, (k % mpc)*bpm : (k % mpc + 1)*bpm]``), gathered on
        the batch's device in one indexing op per leaf. -> (batch, keep)
        with ``keep`` a bool [N] mask of clusters with resident data (None
        when all have). Under ``duplicate`` the batch also carries
        ``row_weight`` [N, localB], ``1/n_copies`` of each row's source
        shard, which the loss (``launch.steps.make_loss_fn``) applies."""
        leaves = tree_leaves(batch)
        if not leaves or leaves[0].ndim < 2:
            return batch, None
        N, mpc = self.hfl.num_clusters, self.hfl.mus_per_cluster
        localB = leaves[0].shape[1]
        dup = (isinstance(batch, dict) and self.residency is not None
               and self.residency.policy == "duplicate")
        if self._oversub:
            # fleet-scale batches carry no per-MU identity (more shards
            # than data slots): the slots train on the cluster's rows as
            # they are, while ``src`` drives pricing, accounting, idling
            # and the duplicate-policy row weights
            keep = src[:, 0] >= 0
            out = batch
            if dup and localB % mpc == 0:
                w_slot = np.where(
                    src >= 0,
                    self.residency.shard_weights_at(np.maximum(src, 0)), 1.0)
                out = dict(batch)
                out["row_weight"] = self._row_weight(
                    np.repeat(w_slot, localB // mpc, axis=1), leaves[0])
            return out, (None if keep.all() else keep)
        if localB % mpc:
            return batch, None  # unknown row layout; leave untouched
        bpm = localB // mpc
        keep = src[:, 0] >= 0
        static = (np.arange(N) * mpc)[:, None] + np.arange(mpc)[None, :]
        srcf = np.where(src >= 0, src, static)  # kept-out rows: identity
        cl = np.repeat(srcf // mpc, bpm, axis=1)  # [N, localB]
        row = (np.repeat((srcf % mpc) * bpm, bpm, axis=1)
               + np.tile(np.arange(bpm), (N, mpc)))
        clt = torch.from_numpy(cl).to(leaves[0].device)
        rowt = torch.from_numpy(row).to(leaves[0].device)
        out = tree_map(lambda leaf: leaf[clt, rowt] if leaf.ndim >= 2 else leaf,
                       batch)
        if dup:
            out["row_weight"] = self._row_weight(
                np.repeat(self.residency.shard_weights()[srcf], bpm, axis=1),
                leaves[0])
        return out, (None if keep.all() else keep)

    def _gather_row(self, batch, src_n: np.ndarray, n: int):
        """Row-only variant of ``_gather_batch`` for the masked step:
        cluster ``n``'s [localB] rows gathered from its resident MUs' data
        slots. ``src_n`` has no -1 entries (the caller idles those
        rounds)."""
        leaves = tree_leaves(batch)
        take_row = lambda leaf: leaf[n] if leaf.ndim >= 2 else leaf
        if not leaves or leaves[0].ndim < 2:
            return tree_map(take_row, batch)
        mpc = self.hfl.mus_per_cluster
        localB = leaves[0].shape[1]
        dup = (isinstance(batch, dict) and self.residency is not None
               and self.residency.policy == "duplicate")
        if self._oversub:
            out = tree_map(take_row, batch)
            if dup and localB % mpc == 0:
                out["row_weight"] = self._row_weight(np.repeat(
                    self.residency.shard_weights_at(src_n), localB // mpc),
                    leaves[0])
            return out
        if localB % mpc:
            return tree_map(take_row, batch)  # unknown layout: slice
        bpm = localB // mpc
        cl = np.repeat(src_n // mpc, bpm)  # [localB]
        row = np.repeat((src_n % mpc) * bpm, bpm) + np.tile(np.arange(bpm), mpc)
        clt = torch.from_numpy(cl).to(leaves[0].device)
        rowt = torch.from_numpy(row).to(leaves[0].device)
        out = tree_map(lambda leaf: leaf[clt, rowt] if leaf.ndim >= 2 else leaf,
                       batch)
        if dup:
            out["row_weight"] = self._row_weight(np.repeat(
                self.residency.shard_weights()[src_n], bpm), leaves[0])
        return out

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
        launch (zeros in null-wireless mode)."""
        self._train_launches += 1
        if not self.wireless:
            return 0.0, 0.0
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

    def _count_sync_hier(self, top: int):
        """Analytic fronthaul charge of one tiered-consensus boundary up to
        tier ``top`` -> ``(ul_bits, dl_bits)``: each firing tier t prices
        ``A_{t-1}`` child uplinks and ``A_t`` parent downlinks at that
        boundary's link payloads (``latency.tier_payload_bits``)."""
        self._sync_launches += 1
        if not self.wireless:
            return 0.0, 0.0
        pb = tier_payload_bits(self.lp, self.hfl.tiers)
        ul = dl = 0.0
        for ti in range(1, top + 1):
            ul_l, dl_l = boundary_links(ti)
            ul += self.hfl.agg_count(ti - 1) * pb[ul_l]
            dl += self.hfl.agg_count(ti) * pb[dl_l]
        self._bits_fronthaul += ul + dl
        return ul, dl

    def _hier_sync_extra_s(self, top: int) -> float:
        """Serial fronthaul time the tiers ABOVE the SBS ring add to one
        boundary (tier 1's θ^U/θ^D already live in ``ctx['sync_s']``):
        every extra hop ships its Ω payload pair over the fronthaul rate."""
        if not self.wireless or top < 2:
            return 0.0
        aux = self._latency_aux()
        pb = tier_payload_bits(self.lp, self.hfl.tiers)
        extra = 0.0
        for ti in range(2, top + 1):
            ul_l, dl_l = boundary_links(ti)
            extra += (pb[ul_l] + pb[dl_l]) / aux["fh_rate"]
        return extra

    def _count_sync_unit(self, utop: int, cut: int):
        """Analytic fronthaul charge of ONE unit's cascade up to tier
        ``utop``, the within-unit slice of ``_count_sync_hier``."""
        self._sync_launches += 1
        if not self.wireless:
            return 0.0, 0.0
        lp, tiers = self.lp, self.hfl.tiers

        def width(j: int) -> int:  # tier-j aggregators per unit
            out = 1
            for k in range(j + 1, cut):
                out *= tiers[k].fanout
            return out

        ul = dl = 0.0
        for ti in range(1, utop + 1):
            ul += width(ti - 1) * lp.payload(tiers[ti].phi_up)
            dl += width(ti) * lp.payload(tiers[ti].phi_down)
        self._bits_fronthaul += ul + dl
        return ul, dl

    def _count_sync_push(self, t: int):
        """Analytic fronthaul charge of one async push across boundary
        ``t``: the Ω uplink at the tier's ``phi_up``, the dense adoption
        downlink (the child pulls the parent's whole reference)."""
        self._sync_launches += 1
        if not self.wireless:
            return 0.0, 0.0
        ul = self.lp.payload(self.hfl.tiers[t].phi_up)
        dl = self.lp.payload(0.0)
        self._bits_fronthaul += ul + dl
        return ul, dl

    def _measure_sync_hier(self, state, hbufs, top: int):
        """The REAL per-boundary payloads of one tiered consensus (depth > 2
        measured accounting) -> ``(ul_bits, dl_bits, sync_s, bcast_bits,
        legs, row_bits)``. The hier probe runs
        the cascade's selection on the same ``(state, bufs)`` before the
        in-place sync; its device counts come to the host in ONE copy.
        Each boundary lands on ITS ledger links (``sbs_ul``/``mbs_dl``,
        then ``t{t}_ul``/``t{t}_dl``); the sync time is re-priced from the
        bits (each boundary a serial hop pair, its slowest child fanning
        in over the fronthaul), and the post-consensus SBS->MU broadcast
        ships each cluster's adopted tier-1 delta at its realized DL
        rate. ``legs`` carries (link, bits, dur) span pairs holding exactly
        the ledger-recorded floats, for the span/ledger conservation
        check."""
        uls, dls = self._probe(state, hbufs, top)
        counts = torch.cat([*uls, *dls]).cpu().numpy().astype(np.float64)
        sizes = [int(b.numel()) for b in (*uls, *dls)]
        parts = np.split(counts, np.cumsum(sizes)[:-1])
        self._sync_launches += 1
        aux = self._latency_aux()
        legs = []
        row_bits = {}
        ul_tot = dl_tot = sync_s = 0.0
        for ti in range(1, top + 1):
            ub, db = parts[ti - 1], parts[top + ti - 1]
            ul_l, dl_l = boundary_links(ti)
            u_rec = self.ledger.record(ul_l, float(ub.sum()), events=int(ub.size))
            d_rec = self.ledger.record(dl_l, float(db.sum()), events=int(db.size))
            ul_tot += u_rec
            dl_tot += d_rec
            u_dur = float(ub.max()) / aux["fh_rate"]
            d_dur = float(db.max()) / aux["fh_rate"]
            sync_s += u_dur + d_dur
            legs.append((ul_l, u_rec, u_dur, dl_l, d_rec, d_dur))
            row_bits[f"bits_{ul_l}"] = u_rec
            row_bits[f"bits_{dl_l}"] = d_rec
        self._bits_fronthaul += ul_tot + dl_tot
        # cluster n re-broadcasts its tier-1 aggregator's downlink; clusters
        # mobility has emptied (dl_rate=inf) are charged neither
        per_cluster = np.repeat(parts[top], self.hfl.tiers[1].fanout)
        finite = np.isfinite(aux["dl_rates"])
        t_bcast = np.where(finite, per_cluster / aux["dl_rates"], 0.0)
        n_bcast = int(finite.sum())
        bcast_b = None
        if n_bcast:
            bcast_b = self.ledger.record(
                "sbs_dl", float(per_cluster[finite].sum()), events=n_bcast)
            self._bits_access += bcast_b
            sync_s += float(t_bcast[finite].max())
        row_bits["bits_sync_bcast"] = (
            float(per_cluster[finite].sum()) if n_bcast else 0.0)
        return ul_tot, dl_tot, sync_s, bcast_b, legs, row_bits

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

    def _finish_run(self) -> None:
        """Engine teardown: final registry totals, then the span/ledger
        payload-bit conservation bugcheck (measured accounting) — every
        link's span bits must equal the ledger's total bit-for-bit."""
        if not self.obs.enabled:
            return
        reg = self.obs.registry
        reg.counter("sim.train_launches").inc(self._train_launches)
        reg.counter("sim.sync_launches").inc(self._sync_launches)
        reg.counter("sim.bits_access").inc(self._bits_access)
        reg.counter("sim.bits_fronthaul").inc(self._bits_fronthaul)
        part, seen = self._rounds_part, self._rounds_seen
        if part is not None and int(seen.sum()) > 0:
            rate = part / np.maximum(seen, 1)
            for n in range(part.size):
                reg.gauge("sim.participation_rate").set(
                    float(rate[n]), cluster=f"c{n}")
            # drop-fairness: Gini over rounds contributed (0 = every
            # cluster trained equally often, ->1 = one cluster hogs)
            x = np.sort(part.astype(np.float64))
            k, tot = x.size, float(x.sum())
            gini = 0.0 if tot <= 0 or k < 2 else float(
                2.0 * np.sum(np.arange(1, k + 1) * x) / (k * tot)
                - (k + 1) / k)
            reg.gauge("sim.drop_gini").set(gini)
        if self.ledger is not None:
            self.obs.check_conservation(self.ledger)

    def _mark_round(self, n: int, participated: bool, t: float) -> None:
        """Per-cluster round outcome under async (obs on only): feeds the
        participation/Gini tallies and the dead-cluster health signal."""
        if self._rounds_seen is None:
            return
        self._rounds_seen[n] += 1
        if participated:
            self._rounds_part[n] += 1
        self.obs.health.ingest_cluster_round(int(n), participated, t=t)

    # --- span emission (telemetry on only; never touches sim state) ------

    def _trace_train_step(self, step: int, t0: float, ctx: dict,
                          ul_bits: float, dl_bits: float) -> None:
        """Virtual-clock spans of one lockstep training iteration: the
        engine-track iter span, per-cluster compute/UL/DL phase spans, and
        the two access-link payload spans (bits = the ledger's floats)."""
        tr = self.obs.tracer
        dur = ctx["iter_s"]
        tr.span("iter", track="engine", t0=t0, dur=dur,
                args={"step": step, "dropped": ctx["dropped"],
                      "participants": ctx["participants"]})
        ph = ctx.get("phases")
        if ph is not None:
            for n in np.nonzero(ph["surv"] > 0)[0]:
                tt = t0
                for phase in ("comp", "ul", "dl"):
                    d = float(ph[phase][n])
                    tr.span(phase, track=f"cluster{int(n)}", t0=tt, dur=d)
                    tt += d
        if self.wireless:
            tr.link_span("mu_ul", t0=t0, dur=dur, bits=ul_bits,
                         name="train_ul",
                         args={"participants": ctx["participants"]})
            tr.link_span("sbs_dl", t0=t0, dur=dur, bits=dl_bits,
                         name="train_dl")

    def _trace_sync(self, step: int, t0: float, sync_s: float,
                    ul_bits: float, dl_bits: float, bcast_bits,
                    fh_parts, extra: dict, legs=None) -> None:
        """Virtual-clock spans of one global consensus: the engine-track
        sync span plus fronthaul UL/DL link spans and (measured mode) the
        repriced SBS->MU broadcast span. ``fh_parts`` carries the measured
        per-leg durations; the analytic path falls back to the aux θ's.
        ``legs`` (depth > 2 measured) replaces the fixed fronthaul pair
        with one tier-labelled span pair per cascade boundary, each
        carrying exactly the ledger-recorded bits, laid out serially up
        the tree."""
        tr = self.obs.tracer
        tr.span("sync", track="engine", t0=t0, dur=sync_s,
                args={"step": step, **extra})
        if not self.wireless:
            return
        if legs is not None:
            tt = t0
            for ul_l, ub, ud, dl_l, db, dd in legs:
                tr.link_span(ul_l, t0=tt, dur=ud, bits=ub, name="sync_ul")
                tt += ud
                tr.link_span(dl_l, t0=tt, dur=dd, bits=db, name="sync_dl")
                tt += dd
            if bcast_bits is not None:
                tr.link_span("sbs_dl", t0=tt,
                             dur=max(sync_s - (tt - t0), 0.0),
                             bits=bcast_bits, name="sync_bcast")
            return
        if fh_parts is not None:
            fh_ul, fh_dl, t_bc = fh_parts
        else:
            aux = self._latency_aux()
            fh_ul, fh_dl = float(aux["theta_u"]), float(aux["theta_d"])
            t_bc = max(sync_s - fh_ul - fh_dl, 0.0)
        tr.link_span("sbs_ul", t0=t0, dur=fh_ul, bits=ul_bits,
                     name="sync_ul")
        tr.link_span("mbs_dl", t0=t0 + fh_ul, dur=fh_dl, bits=dl_bits,
                     name="sync_dl")
        if bcast_bits is not None:
            tr.link_span("sbs_dl", t0=t0 + fh_ul + fh_dl, dur=t_bc,
                         bits=bcast_bits, name="sync_bcast")

    # --- lockstep / deadline ---------------------------------------------

    def _run_lockstep(
        self, state, train_step, sync_step, batches, num_steps, on_step,
        *, deadline: bool,
    ):
        H = self.period
        it = iter(batches)
        trace = Trace(meta=self._meta(), record=self._record)
        t = 0.0
        ctx: dict = {}
        N = self.hfl.num_clusters
        # health stats ride the sync step only when BOTH the monitor is on
        # and the caller built the sync with collect_stats
        stats_on = (self.obs.health.enabled
                    and bool(getattr(sync_step, "collect_stats", False)))
        # depth > 2: the tiered sync threads its own side buffers and fires
        # a variable-height boundary (hier_fire_top) each period
        hier = bool(getattr(sync_step, "hier", False))
        hbufs = sync_step.init_bufs(state) if hier else None
        for step in range(num_steps):
            if step % H == 0:
                # the virtual clock feeds the diurnal availability curve
                self._vt = t
                ctx = self._round_ctx(deadline)
                if self._rounds_seen is not None:
                    src = ctx.get("src")
                    if src is not None:
                        part = src[:, 0] >= 0
                    elif ctx["keep_clusters"] is not None:
                        part = np.asarray(ctx["keep_clusters"], bool)
                    else:
                        part = np.ones(N, bool)
                    self._rounds_seen += 1
                    self._rounds_part += part
                    self.obs.health.ingest_round(part, t=t)
            if self.residency is not None:
                batch, keep = self._gather_batch(next(it), ctx["src"])
            else:
                batch = self._apply_participation(next(it), ctx["mask"])
                keep = ctx["keep_clusters"]
            with self.obs.host_span("train_step"):
                if keep is not None:  # sat-out clusters: loss only, no update
                    state, loss = train_step(state, batch, keep=keep)
                else:
                    state, loss = train_step(state, batch)
            t_iter0 = t
            t += ctx["iter_s"]
            ul_b, dl_b = self._count_train(ctx["participants"],
                                           ctx.get("active_clusters", N))
            if self.obs.enabled:
                self._trace_train_step(step, t_iter0, ctx, ul_b, dl_b)
            if self._record or self.obs.health.enabled:
                loss_mean = float(loss.float().mean())
                self.obs.health.ingest_loss(loss_mean, t=t)
                trace.add(kind="train", t=t, step=step, loss=loss_mean,
                          dropped=ctx["dropped"])
            if (step + 1) % H == 0:
                sync_s = ctx["sync_s"]
                row_extra = {}
                sync_ul = sync_dl = 0.0
                bcast_b = fh_parts = legs = None
                if hier:
                    top = sync_step.fire_top((step + 1) // H)
                    row_extra = {"tier": int(top)}
                    if self.ledger is not None:
                        # the cascade's REAL per-boundary payloads, measured
                        # before the in-place sync, re-price the boundary
                        (sync_ul, sync_dl, sync_s, bcast_b, legs,
                         row_bits) = self._measure_sync_hier(state, hbufs, top)
                        row_extra.update(row_bits)
                    else:
                        sync_ul, sync_dl = self._count_sync_hier(top)
                        sync_s += self._hier_sync_extra_s(top)
                elif self.ledger is not None:
                    # measure the REAL fronthaul payloads this sync sends
                    # (before the in-place sync consumes the state) and
                    # re-price θ^U/θ^D from the actual bit counts
                    ul_b, dl_b = self._probe_host(state)
                    sync_ul, sync_dl = self._count_sync_measured(ul_b, dl_b)
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
                        bcast_b = self.ledger.record(
                            "sbs_dl", n_bcast * dl_b, events=n_bcast)
                        self._bits_access += bcast_b
                    sync_s = float(
                        (ul_b.max() + dl_b) / aux["fh_rate"]
                        + (t_bcast[finite].max() if n_bcast else 0.0)
                    )
                    row_extra = {"bits_sbs_ul": float(ul_b.sum()),
                                 "bits_mbs_dl": dl_b,
                                 "bits_sync_bcast": n_bcast * dl_b}
                    if self.obs.enabled:
                        # viz-only leg durations; sync_s itself stays the
                        # single fused expression above (bit-identity)
                        fh_parts = (
                            float(ul_b.max()) / aux["fh_rate"],
                            dl_b / aux["fh_rate"],
                            float(t_bcast[finite].max()) if n_bcast else 0.0,
                        )
                else:
                    sync_ul, sync_dl = self._count_sync(N)
                with self.obs.host_span("sync_step"):
                    if hier:
                        state, hbufs = sync_step(state, hbufs, top)
                    elif stats_on:
                        state, sstats = sync_step(state)
                    else:
                        state = sync_step(state)
                t_sync0 = t
                t += sync_s
                if self.obs.enabled:
                    self._trace_sync(step, t_sync0, sync_s, sync_ul, sync_dl,
                                     bcast_b, fh_parts, row_extra, legs=legs)
                if stats_on:
                    self.obs.health.ingest_sync_stats(sstats, t=t)
                    self.obs.health.ingest_payload(sync_ul + sync_dl, t=t)
                    del sstats  # the index sets: not alive through the next sync
                trace.add(kind="sync", t=t, step=step, dropped=ctx["dropped"],
                          deadline_s=ctx["deadline_s"], iter_s=ctx["iter_s"],
                          sync_s=sync_s, **row_extra)
                self._advance_fleet(H * ctx["iter_s"] + sync_s, now=t)
            if on_step is not None:
                on_step(step, state, loss)
            self.obs.tick()
        self._finish_run()
        trace.meta.update(self._totals())
        return state, trace

    # --- async ------------------------------------------------------------

    def _cluster_round_times(self, comp: np.ndarray) -> np.ndarray:
        """Async round times for ALL clusters at the current pricing [N],
        cached until the fleet moves (``_advance_fleet`` clears it): one
        scatter-max over the resident (or radio) membership."""
        if self._crt is not None:
            return self._crt
        N = self.hfl.num_clusters
        if not self.wireless:
            self._crt = np.full(N, self.period * self.sim.base_compute_s)
            return self._crt
        aux = self._latency_aux()
        # compute follows the DATA: with a residency tracker the round's
        # trainers are the resident shards' host MUs
        if self.residency is not None:
            cols, starts = self.residency.members_csr()
            counts = np.diff(starts)
            comp_n = np.full(N, -np.inf)
            np.maximum.at(comp_n, np.repeat(np.arange(N), counts), comp[cols])
        else:
            counts = self.fleet.cluster_sizes()
            comp_n = self.fleet.cluster_comp_max(self.sim.base_compute_s)
        comp_n = np.where(counts > 0, comp_n, self.sim.base_compute_s)
        g = aux["gamma_ul"] + aux["gamma_dl"]
        self._crt = (self.period * (comp_n + g)
                     + aux["theta_u"] + aux["theta_d"])
        return self._crt

    def _cluster_round_time(self, n: int, comp: np.ndarray) -> float:
        return float(self._cluster_round_times(comp)[n])

    def _run_async(self, state, train_step, batches, num_steps, on_step,
                   masked_train_step=None, on_async_sync=None):
        """Clusters sync with the MBS on their own clocks: the reference's
        ``_run_async`` (event queue, staleness weights, idle rounds,
        availability/fault/selector masks, measured or analytic
        accounting), with the port's in-place steps."""
        hfl = self.hfl
        N, H = hfl.num_clusters, self.period
        rounds = num_steps // H
        trace = Trace(meta=self._meta(), record=self._record)
        if rounds == 0:
            trace.meta.update(self._totals())
            return state, trace
        it = iter(batches)
        q = EventQueue()
        dl_sparse = bool(hfl.async_dl_sparse)
        measured = self.ledger is not None
        stats_on = self.obs.health.enabled
        sent = {}
        sync_n = make_async_sync_step(
            hfl, dl_sparse=dl_sparse, codec=self._codec if measured else None,
            collect_stats=stats_on,
            on_payloads=(None if on_async_sync is None else
                         lambda n, up, down: sent.update(uplink=up,
                                                         downlink=down)))
        e_dl = init_dl_error(state, hfl) if dl_sparse else None
        comp = self.fleet.compute_times(self.sim.base_compute_s)
        for n in range(N):
            q.push(self._cluster_round_time(n, comp),
                   Event("cluster_done", cluster=n, round=0))
        global_updates = 0
        last_pull = [0] * N
        steps_done = 0
        fleet_time = 0.0
        mpc = hfl.mus_per_cluster
        fault = getattr(self.sim, "fault_dead_cluster", None)
        # per-cluster round start times (virtual): round r of cluster n
        # occupies [round_t0[n], its pop time]; tracked for the trace spans
        round_t0 = np.zeros(N)
        while len(q):
            t, ev = q.pop()
            n = ev.cluster
            if self.fleet.mobile:
                self._advance_fleet(t - fleet_time, now=t)
                fleet_time = t
            # availability: unavailable MUs in this cluster's data slots
            # (static layout, or the resident shards under a tracker) sit
            # the round out, their rows resampled from the survivors; a
            # cluster with no available data idles the whole round. Round
            # TIMES are not availability-adjusted.
            mask = None
            src = None
            dropped = 0
            n_res = 0
            self._vt = t
            avail = (self.fleet.draw_available(t) if self.fleet.dropout > 0
                     else None)
            if fault is not None:
                if avail is None:
                    avail = np.ones(self.fleet.K, bool)
                avail = avail & (self.fleet.cid != fault)
            if self.selector is not None:
                if avail is None:
                    avail = np.ones(self.fleet.K, bool)
                avail = self.selector.select(avail, self.fleet, t)
            idle = False
            if self.residency is not None:
                src = self._slot_sources(avail)
                row_n = self.residency.holds[n]
                n_res = int(row_n.sum())
                if avail is not None:
                    dropped = n_res - int((row_n & avail).sum())
                idle = src[n, 0] < 0  # no available resident shard
            elif avail is not None:
                slots = slice(n * mpc, (n + 1) * mpc)
                dropped = int((~avail[slots]).sum())
                idle = not avail[slots].any()
                if dropped and not idle:
                    mask = np.ones(self.fleet.K, bool)
                    mask[slots] = avail[slots]
            if idle:
                trace.add(kind="idle", t=t, cluster=int(n),
                          round=int(ev.round), dropped=dropped)
                if self.obs.enabled:
                    self.obs.tracer.span(
                        "idle", track=f"cluster{n}", t0=round_t0[n],
                        dur=t - round_t0[n],
                        args={"round": int(ev.round), "dropped": dropped})
                self._mark_round(n, False, t)
                round_t0[n] = t
                self.obs.tick()
                if ev.round + 1 < rounds:
                    q.push(t + self._cluster_round_time(n, comp),
                           Event("cluster_done", cluster=n,
                                 round=ev.round + 1))
                continue
            members = int(self.fleet.cluster_sizes()[n])
            # access links charge the MUs whose data trains this round: at
            # most mpc slots under a tracker, the surviving radio members
            # otherwise
            participants = (min(n_res - dropped, mpc)
                            if self.residency is not None
                            else max(members - dropped, 0))
            # staleness is fixed before this round's own consensus lands:
            # the round's weight is known up front, so the round span is
            # emitted first and per-track span starts stay monotone
            staleness = global_updates - last_pull[n]
            w = async_weight(staleness, N, self.sim.staleness_exp)
            iter_w = sync_tail = 0.0
            if self.obs.enabled:
                # round window [round_t0, t]: H iteration windows plus the
                # θ^U+θ^D sync tail (clamped — pricing may have moved since
                # the round was scheduled); viz decomposition only
                W = t - round_t0[n]
                if self.wireless:
                    aux = self._latency_aux()
                    sync_tail = min(float(aux["theta_u"] + aux["theta_d"]), W)
                iter_w = max(W - sync_tail, 0.0) / H
                self.obs.tracer.span(
                    "round", track=f"cluster{n}", t0=round_t0[n], dur=W,
                    args={"round": int(ev.round), "staleness": int(staleness),
                          "weight": float(w), "dropped": dropped})
            # state.step feeds the LR schedule: THIS cluster's per-round
            # progress, not the global launch count
            state = state._replace(step=ev.round * H)
            onehot = np.arange(N) == n
            loss = None
            for h in range(H):
                batch = next(it)
                if masked_train_step is not None:
                    # only the active cluster, and only ITS rows gathered
                    if self.residency is not None:
                        batch_n = self._gather_row(batch, src[n], n)
                    else:
                        batch_n = tree_map(
                            lambda l: l[n] if l.ndim >= 2 else l,
                            self._apply_participation(batch, mask))
                    with self.obs.host_span("train_step"):
                        state, loss = masked_train_step(state, batch_n, n)
                else:
                    if self.residency is not None:
                        batch, _keep = self._gather_batch(batch, src)
                    else:
                        batch = self._apply_participation(batch, mask)
                    # the other clusters' rows stay as they were (the
                    # reference's _take_cluster_row)
                    with self.obs.host_span("train_step"):
                        state, loss = train_step(state, batch, keep=onehot)
                steps_done += 1
                ul_b, dl_b = self._count_train(participants, 1)
                if self.obs.enabled and self.wireless:
                    # async link spans live on the cluster track: rounds
                    # overlap across clusters, so shared link tracks would
                    # break per-track time ordering
                    it0 = round_t0[n] + h * iter_w
                    tr_ = self.obs.tracer
                    tr_.link_span("mu_ul", t0=it0, dur=iter_w, bits=ul_b,
                                  name="train_ul", track=f"cluster{n}")
                    tr_.link_span("sbs_dl", t0=it0, dur=iter_w, bits=dl_b,
                                  name="train_dl", track=f"cluster{n}")
            if on_async_sync is not None:
                _wait(e_dl if e_dl is not None else state)
                t_sync = time.perf_counter()
            sstats = None
            with self.obs.host_span("sync_step"):
                # variants append (bits?, stats?) after the carried state
                if dl_sparse:
                    out = sync_n(state, e_dl, n, w)
                    state, e_dl, rest = out[0], out[1], out[2:]
                elif measured or stats_on:
                    out = sync_n(state, n, w)
                    state, rest = out[0], out[1:]
                else:
                    state, rest = sync_n(state, n, w), ()
                if stats_on:
                    sstats = rest[-1]
            if on_async_sync is not None:
                _wait(e_dl if e_dl is not None else state)
                sync_wall = time.perf_counter() - t_sync
            global_updates += 1
            last_pull[n] = global_updates
            if measured:
                bits = rest[0]
                # the device counts come to the host in one copy; the
                # dense adoption pulls the whole reference (static Q bits)
                keys = sorted(bits)
                counts = torch.stack([bits[k].reshape(()) for k in keys])
                host = dict(zip(keys, counts.tolist()))
                dl_b = (float(host["mbs_dl"]) if dl_sparse
                        else float(self._ab["dense"]))
                s_ul, s_dl = self._count_sync_measured(
                    [float(host["sbs_ul"])], dl_b)
            else:
                s_ul, s_dl = self._count_sync(1)
            if self.obs.enabled:
                self.obs.registry.histogram("sim.staleness").observe(
                    float(staleness), cluster=f"c{n}")
            if sstats is not None:
                self.obs.health.ingest_async_sync_stats(
                    sstats, n, staleness, t=t)
                self.obs.health.ingest_payload(s_ul + s_dl, t=t)
                sstats = None  # the index sets: not alive through the next event
            self._mark_round(n, True, t)
            if self.obs.enabled:
                tr_ = self.obs.tracer
                t_s0 = t - sync_tail
                tr_.span("sync", track=f"cluster{n}", t0=t_s0, dur=sync_tail,
                         args={"round": int(ev.round),
                               "staleness": int(staleness),
                               "weight": float(w)})
                if self.wireless:
                    tr_.link_span("sbs_ul", t0=t_s0, dur=sync_tail, bits=s_ul,
                                  name="sync_ul", track=f"cluster{n}")
                    tr_.link_span("mbs_dl", t0=t_s0, dur=sync_tail, bits=s_dl,
                                  name="sync_dl", track=f"cluster{n}")
            # the ACTIVE cluster's loss: the fallback computes all N rows
            loss_n = float(loss if loss.dim() == 0 else loss[n])
            self.obs.health.ingest_loss(loss_n, t=t)
            trace.add(kind="sync", t=t, step=steps_done - 1, cluster=int(n),
                      round=int(ev.round), staleness=int(staleness),
                      weight=float(w), dropped=dropped, loss=loss_n)
            if on_async_sync is not None:
                event = dict(index=global_updates, cluster=int(n),
                             round=int(ev.round), staleness=int(staleness),
                             weight=float(np.float32(w)), seconds=sync_wall,
                             bits_sbs_ul=s_ul, bits_mbs_dl=s_dl, **sent)
                sent.clear()
                on_async_sync(event, state)
            if on_step is not None:
                on_step(steps_done - 1, state, loss)
            if ev.round + 1 < rounds:
                q.push(t + self._cluster_round_time(n, comp),
                       Event("cluster_done", cluster=n, round=ev.round + 1))
            round_t0[n] = t
            self.obs.tick()
        self._finish_run()
        trace.meta.update(self._totals())
        return state, trace

    # --- mixed-discipline hierarchy: async boundaries above a cut ----------

    def _run_units(self, state, train_step, sync_step, batches, num_steps,
                   on_step, on_async_sync=None, *, cut: int):
        """Tier-recursive async scheduler (the reference's ``_run_units``):
        every boundary at or above ``cut`` runs clock-free, everything below
        stays lockstep. The subtree under one tier-``cut-1`` aggregator is a
        scheduling **unit**: it runs tier-1 rounds on its own clock (H
        iterations of ITS clusters, then its within-unit cascade of
        boundaries 1..cut-1 at their lockstep cadences) and every
        ``prod(tiers[2..cut].period)`` unit rounds pushes its reference
        across the cut with a staleness-discounted weight (``async_weight``
        over the ``tiers[cut].fanout`` siblings). A push landing on a parent
        may cascade further up: boundary t > cut fires after every
        ``tiers[t].period`` pushes the parent receives."""
        from repro_torch.core.hfl import hier_fire_top

        hfl = self.hfl
        tiers = hfl.tiers
        T = len(tiers)
        if self.residency is not None or self._oversub:
            raise ValueError(
                "async tier boundaries do not support residency "
                "tracking or oversubscribed fleets yet")
        if self.ledger is not None:
            raise ValueError(
                "payload_accounting='measured' is not supported above an "
                "async tier boundary at depth > 2 yet: the hier probe "
                "mirrors the synchronous cascade, not per-unit push "
                "payloads")
        H = self.period
        N = hfl.num_clusters
        U = hfl.agg_count(cut - 1)  # async units (tier cut-1 aggregators)
        G = N // U                  # clusters per unit
        Hc = 1  # unit rounds between cut pushes
        for ti in range(2, cut + 1):
            Hc *= tiers[ti].period
        mpc = hfl.mus_per_cluster
        rounds = num_steps // H
        trace = Trace(meta=self._meta(), record=self._record)
        trace.meta["hier_depth"] = T
        if rounds == 0:
            trace.meta.update(self._totals())
            return state, trace
        it = iter(batches)
        q = EventQueue()
        bufs = sync_step.init_bufs(state)
        unit_sync, push = sync_step.unit_ops(cut)
        fleet = self.fleet
        comp = (fleet.compute_times(self.sim.base_compute_s)
                if fleet is not None else None)

        def unit_rt(u: int) -> float:
            crt = self._cluster_round_times(comp)
            return float(crt[u * G:(u + 1) * G].max())

        def timed(fn, st, *args):
            """fn(st, bufs, *args) -> (state, bufs, wall seconds or None)."""
            if on_async_sync is None:
                return (*fn(st, bufs, *args), None)
            _wait(st)
            t0 = time.perf_counter()
            st, b = fn(st, bufs, *args)
            _wait(st)
            return st, b, time.perf_counter() - t0

        for u in range(U):
            q.push(unit_rt(u), Event("unit_done", cluster=u, round=0))
        # per-boundary bookkeeping (boundaries cut..T-1): pushes LANDED per
        # parent, each child's parent-counter at its last pull, and (above
        # the cut) pushes a parent has received since it last fired upward
        updates = {tb: [0] * hfl.agg_count(tb) for tb in range(cut, T)}
        last_pull = {tb: [0] * hfl.agg_count(tb - 1) for tb in range(cut, T)}
        pending = {tb: [0] * hfl.agg_count(tb - 1) for tb in range(cut + 1, T)}
        steps_done = 0
        n_syncs = 0
        fleet_time = 0.0
        fault = getattr(self.sim, "fault_dead_cluster", None)
        round_t0 = np.zeros(U)
        while len(q):
            t, ev = q.pop()
            u = ev.cluster
            if fleet is not None and fleet.mobile:
                self._advance_fleet(t - fleet_time, now=t)
                fleet_time = t
            self._vt = t
            avail = (fleet.draw_available(t)
                     if fleet is not None and fleet.dropout > 0 else None)
            if fault is not None and fleet is not None:
                if avail is None:
                    avail = np.ones(fleet.K, bool)
                avail = avail & (fleet.cid != fault)
            slots = slice(u * G * mpc, (u + 1) * G * mpc)
            if self.selector is not None:
                if avail is None:
                    avail = np.ones(fleet.K, bool)
                # the policy runs over THIS unit's clusters at ITS round time
                sel = self.selector.select(avail, fleet, t,
                                           clusters=range(u * G, (u + 1) * G))
                avail = avail.copy()
                avail[slots] = sel[slots]
            unit_clusters = np.zeros(N, bool)
            unit_clusters[u * G:(u + 1) * G] = True
            mask = None
            dropped = 0
            if avail is not None:
                mask = None if avail.all() else avail
                dropped = int((~avail[slots]).sum())
            # the unit's clusters with a participant train; every other
            # row stays as it was
            keep = unit_clusters
            if mask is not None:
                keep = unit_clusters & mask.reshape(N, mpc).any(axis=1)
            participants = (int(avail[slots].sum()) if avail is not None
                            else G * mpc)
            # step-indexed LR schedules follow THIS unit's round progress
            state = state._replace(step=ev.round * H)
            loss = None
            for _ in range(H):
                batch = self._apply_participation(next(it), mask)
                with self.obs.host_span("train_step"):
                    state, loss = train_step(state, batch, keep=keep)
                steps_done += 1
                self._count_train(participants, int(keep.sum()))
            # within-unit consensus: boundaries 1..utop at their lockstep
            # cadences, capped below the cut
            utop = min(hier_fire_top(tiers, ev.round + 1), cut - 1)
            if utop >= 1:
                with self.obs.host_span("sync_step"):
                    state, bufs, secs = timed(unit_sync, state, u, utop)
                s_ul, s_dl = self._count_sync_unit(utop, cut)
                n_syncs += 1
                if on_async_sync is not None:
                    on_async_sync(dict(kind="unit_sync", index=n_syncs,
                                       unit=int(u), tier=int(utop), agg=int(u),
                                       round=int(ev.round), seconds=secs,
                                       bits_ul=s_ul, bits_dl=s_dl), state)
            if (utop >= 1 and self._record) or self.obs.health.enabled:
                # the unit's loss: a host sync
                loss_u = float(loss.float().mean() if loss.dim() == 0
                               else loss[u * G:(u + 1) * G].float().mean())
            if self.obs.enabled:
                self.obs.tracer.span(
                    "round", track=f"edge{u}", t0=round_t0[u],
                    dur=t - round_t0[u],
                    args={"round": int(ev.round), "dropped": dropped})
            for c in range(u * G, (u + 1) * G):
                self._mark_round(c, bool(keep[c]), t)
            if utop >= 1 and self._record:
                trace.add(kind="sync", t=t, step=steps_done - 1,
                          tier=int(utop), edge=int(u), round=int(ev.round),
                          dropped=dropped, loss=loss_u,
                          bits_ul=s_ul, bits_dl=s_dl)
            if self.obs.health.enabled:
                self.obs.health.ingest_loss(loss_u, t=t)
            if (ev.round + 1) % Hc == 0:
                # the push across the cut, cascading up through the counted
                # boundaries above it: staleness counts the updates siblings
                # landed on the parent since this child last pulled
                a, tb = u, cut
                while tb < T:
                    p = a // tiers[tb].fanout
                    staleness = updates[tb][p] - last_pull[tb][a]
                    w = async_weight(staleness, tiers[tb].fanout,
                                     self.sim.staleness_exp)
                    with self.obs.host_span("sync_step"):
                        state, bufs, secs = timed(push, state, tb, a, w)
                    updates[tb][p] += 1
                    last_pull[tb][a] = updates[tb][p]
                    r_ul, r_dl = self._count_sync_push(tb)
                    n_syncs += 1
                    t_push = 0.0
                    if self.wireless:
                        t_push = (r_ul + r_dl) / self._latency_aux()["fh_rate"]
                    t += t_push
                    if self.obs.enabled:
                        label = f"e{a}" if tb == cut else f"t{tb}a{a}"
                        self.obs.registry.histogram("sim.staleness").observe(
                            float(staleness), cluster=label)
                        self.obs.tracer.span(
                            "sync", track=f"edge{u}", t0=t - t_push,
                            dur=t_push,
                            args={"round": int(ev.round), "tier": int(tb),
                                  "staleness": int(staleness),
                                  "weight": float(w)})
                    trace.add(kind="sync", t=t, step=steps_done - 1,
                              tier=int(tb), edge=int(a), round=int(ev.round),
                              staleness=int(staleness), weight=float(w),
                              bits_ul=r_ul, bits_dl=r_dl)
                    if on_async_sync is not None:
                        on_async_sync(dict(kind="push", index=n_syncs,
                                           unit=int(u), tier=int(tb),
                                           agg=int(a), round=int(ev.round),
                                           staleness=int(staleness),
                                           weight=float(np.float32(w)),
                                           seconds=secs, bits_ul=r_ul,
                                           bits_dl=r_dl), state)
                    if tb + 1 >= T:
                        break
                    pend = pending[tb + 1]
                    pend[p] += 1
                    if pend[p] % tiers[tb + 1].period != 0:
                        break
                    a, tb = p, tb + 1
            if on_step is not None:
                on_step(steps_done - 1, state, loss)
            if ev.round + 1 < rounds:
                q.push(t + unit_rt(u),
                       Event("unit_done", cluster=u, round=ev.round + 1))
            round_t0[u] = t
            self.obs.tick()
        self._finish_run()
        trace.meta.update(self._totals())
        return state, trace
