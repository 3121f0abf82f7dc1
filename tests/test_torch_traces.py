"""Mobility-trace replay and data residency on the port against the
reference: ``sim/traces.py`` (generators, CSV/JSONL schema),
``DeviceFleet(trace=)``, ``data.federated.ResidencyTracker`` and the
engine's residency gathers, then the ``manhattan`` scenario end to end.

Everything here is numpy on both sides (the fleet, the traces, the
tracker, the gather indices), so it is compared EXACTLY: the same seed
gives the same trace bit for bit, either package loads the other's files,
and the gathered batch rows and ``row_weight`` are equal. ``manhattan``
(deadline discipline, ``move`` residency) is a lockstep run and keeps
``tests/test_torch_sim.py``'s tolerances.
"""
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import HFLConfig as JHFLConfig
from repro.configs.base import SimConfig as JSimConfig
from repro.data.federated import ResidencyTracker as JTracker
from repro.sim import traces as jtr
from repro.sim.devices import DeviceFleet as JFleet
from repro.sim.engine import SimEngine as JEngine
from repro.wireless.latency import LatencyParams as JLP
from repro.wireless.topology import HCNTopology as JTopo
from repro_torch.configs import HFLConfig as THFLConfig
from repro_torch.configs import parse_tiers_spec as t_parse
from repro_torch.configs.base import SimConfig as TSimConfig
from repro_torch.data import ResidencyTracker as TTracker
from repro_torch.sim import traces as ttr
from repro_torch.sim.devices import DeviceFleet as TFleet
from repro_torch.sim.engine import SimEngine as TEngine
from repro_torch.wireless.latency import LatencyParams as TLP
from repro_torch.wireless.topology import HCNTopology as TTopo

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_sim import _check_same_run, _run_both  # noqa: E402

MODELS = ("random-waypoint", "manhattan", "hotspot-drift")


def _same_trace(a, b):
    assert a.K == b.K
    for ta, tb, pa, pb in zip(a.times, b.times, a.xy, b.xy):
        assert np.array_equal(ta, tb) and np.array_equal(pa, pb)


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("K,seed,speed", [(9, 4, None), (30, 11, 12.5)])
def test_generators_bit_identical(model, K, seed, speed):
    kw = dict(radius=500.0, seed=seed, speed_mps=speed, dt=3.0)
    _same_trace(ttr.generate(model, K, 120.0, **kw),
                jtr.generate(model, K, 120.0, **kw))


@pytest.mark.parametrize("ext", ["csv", "jsonl"])
def test_save_load_across_packages(tmp_path, ext):
    """The two packages write the same bytes, and each loads the other's
    file back to the same trace."""
    t = ttr.generate("hotspot-drift", 7, 60.0, seed=2)
    j = jtr.generate("hotspot-drift", 7, 60.0, seed=2)
    tp, jp = tmp_path / f"port.{ext}", tmp_path / f"ref.{ext}"
    t.save(str(tp))
    j.save(str(jp))
    assert tp.read_bytes() == jp.read_bytes()
    _same_trace(ttr.MobilityTrace.load(str(jp)), jtr.MobilityTrace.load(str(tp)))
    _same_trace(ttr.MobilityTrace.load(str(tp)), t)


def test_irregular_records_and_schema_errors(tmp_path):
    recs = [(5.0, 1, 10.0, -3.0), (0.0, 0, 1.0, 2.0), (0.0, 1, 0.0, 0.0),
            (7.5, 0, -4.0, 8.0), (2.0, 1, 3.0, 3.0)]
    t, j = ttr.MobilityTrace.from_records(recs), jtr.MobilityTrace.from_records(recs)
    _same_trace(t, j)
    for q in (0.0, 1.3, 4.0, 6.0, 99.0):
        assert np.array_equal(t.at(q), j.at(q))
    for bad in ([(0.0, 1, 0.0, 0.0)], [(-1.0, 0, 0.0, 0.0)], []):
        with pytest.raises(ValueError):
            ttr.MobilityTrace.from_records(bad)
    p = tmp_path / "bad.csv"
    p.write_text("t,mu,x,y\n0,0,1,1\n")
    with pytest.raises(ValueError):
        ttr.MobilityTrace.load(str(p))


def test_fleet_replays_the_trace_as_the_reference():
    """``DeviceFleet(trace=)``: positions read off the trace at the fleet's
    accumulated time, nearest-SBS re-association, the compute and
    availability draws untouched by replay."""
    topo_t, topo_j = TTopo(num_clusters=3, seed=1), JTopo(num_clusters=3, seed=1)
    trace_t = ttr.generate("manhattan", 12, 300.0, radius=topo_t.area_radius, seed=5)
    trace_j = jtr.generate("manhattan", 12, 300.0, radius=topo_j.area_radius, seed=5)
    kw = dict(compute_sigma=0.5, dropout=0.2, seed=5)
    ft, fj = TFleet(topo_t, 4, trace=trace_t, **kw), JFleet(topo_j, 4, trace=trace_j, **kw)
    assert ft.mobile and fj.mobile
    assert np.array_equal(ft.pos, fj.pos) and np.array_equal(ft.cid, fj.cid)
    assert np.array_equal(ft.compute_mult, fj.compute_mult)
    moved = 0
    for dt in (7.0, 0.0, 33.5, 120.0, 500.0):
        before = ft.cid.copy()
        ft.advance(dt), fj.advance(dt)
        ft.reassociate(), fj.reassociate()
        moved += int((ft.cid != before).sum())
        assert np.array_equal(ft.pos, fj.pos) and np.array_equal(ft.cid, fj.cid)
        assert np.array_equal(ft.draw_available(dt), fj.draw_available(dt))
    assert moved > 0
    with pytest.raises(AssertionError):
        TFleet(topo_t, 4, trace=trace_t, speed_mps=3.0)


@pytest.mark.parametrize("policy", ["move", "duplicate", "stale"])
def test_residency_tracker_matches_reference(policy):
    rng = np.random.default_rng(7)
    cid0 = rng.integers(0, 4, 40)
    t, j = TTracker(cid0, 4, policy=policy), JTracker(cid0, 4, policy=policy)
    for _ in range(12):
        cid = np.where(rng.random(40) < 0.3, rng.integers(0, 4, 40), cid0)
        t.update(cid), j.update(cid)
        avail = rng.random(40) < 0.7
        idx = rng.integers(0, 40, (3, 5))
        assert np.array_equal(t.holds, j.holds)
        for a, b in zip(t.members_csr(avail), j.members_csr(avail)):
            assert np.array_equal(a, b)
        for a, b in zip(t.members_csr(), j.members_csr()):
            assert np.array_equal(a, b)
        assert np.array_equal(t.members(2), j.members(2))
        assert np.array_equal(t.counts(), j.counts())
        assert np.array_equal(t.copy_counts(), j.copy_counts())
        assert np.array_equal(t.copy_counts_at(idx), j.copy_counts_at(idx))
        assert np.array_equal(t.shard_weights(), j.shard_weights())
        assert np.array_equal(t.shard_weights_at(idx), j.shard_weights_at(idx))
        t.check_conservation()
    t.holds[:, 3] = False  # a lost shard
    with pytest.raises(AssertionError, match="lost"):
        t.check_conservation()
    with pytest.raises(ValueError):
        TTracker(cid0, 4, policy="teleport")


def _engines(policy, fleet_mpc=2):
    """Both packages' engines over 3 clusters x 2 training slots, a fleet of
    3 x ``fleet_mpc`` MUs and a tracker of ``policy``."""
    out = []
    for Topo, Fleet, Tracker, Engine, Sim, LP, hfl in (
            (TTopo, TFleet, TTracker, TEngine, TSimConfig, TLP,
             THFLConfig(tiers=t_parse("3x2:H=2"))),
            (JTopo, JFleet, JTracker, JEngine, JSimConfig, JLP,
             JHFLConfig(num_clusters=3, mus_per_cluster=2, period=2))):
        topo = Topo(num_clusters=3, seed=0)
        fleet = Fleet(topo, fleet_mpc, seed=0)
        tracker = Tracker(fleet.cid, 3, policy=policy)
        out.append(Engine(period=2, hfl_cfg=hfl, sim_cfg=Sim(scenario="custom"),
                          topo=topo, fleet=fleet, lp=LP(model_params=1e5),
                          residency=tracker))
    return out


@pytest.mark.parametrize("policy,fleet_mpc", [("move", 2), ("duplicate", 2),
                                              ("stale", 2), ("move", 5),
                                              ("duplicate", 5)])
def test_residency_gathers_match_reference(policy, fleet_mpc):
    """``_slot_sources`` (with its per-round rotation and an availability
    mask), ``_gather_batch`` (rows, ``keep``, ``row_weight``) and
    ``_gather_row``, on a batch whose rows are distinct tokens, after
    re-associations; ``fleet_mpc`` = 5 oversubscribes the slots."""
    te, je = _engines(policy, fleet_mpc)
    K = 3 * fleet_mpc
    rng = np.random.default_rng(1)
    toks = np.arange(3 * 4 * 3).reshape(3, 4, 3)  # bpm = 2 rows per slot
    for r in range(6):
        cid = rng.integers(0, 3, K)
        if r == 3:
            cid[:] = 1  # clusters 0 and 2 lose every resident (move)
        te.residency.update(cid), je.residency.update(cid)
        mask = None if r % 2 else rng.random(K) < 0.6
        ts, js = te._slot_sources(mask), je._slot_sources(mask)
        assert np.array_equal(ts, js)
        tb, tk = te._gather_batch({"tokens": torch.from_numpy(toks)}, ts)
        jb, jk = je._gather_batch({"tokens": jnp.asarray(toks)}, js)
        assert np.array_equal(tb["tokens"].numpy(), np.asarray(jb["tokens"]))
        assert (tk is None) == (jk is None)
        if tk is not None:
            assert np.array_equal(tk, jk)
        assert ("row_weight" in tb) == ("row_weight" in jb) == (policy == "duplicate")
        if "row_weight" in tb:
            assert tb["row_weight"].dtype == torch.float32
            assert np.array_equal(tb["row_weight"].numpy(), np.asarray(jb["row_weight"]))
        for n in range(3):
            if ts[n, 0] < 0:
                continue
            tr = te._gather_row({"tokens": torch.from_numpy(toks)}, ts[n], n)
            jr = je._gather_row({"tokens": jnp.asarray(toks)}, js[n], n)
            assert np.array_equal(tr["tokens"].numpy(), np.asarray(jr["tokens"]))
            if policy == "duplicate":
                assert np.array_equal(tr["row_weight"].numpy(),
                                      np.asarray(jr["row_weight"]))


def test_oversubscribed_fleet_needs_a_tracker():
    topo = TTopo(num_clusters=3, seed=0)
    with pytest.raises(AssertionError, match="residency tracker"):
        TEngine(period=2, hfl_cfg=THFLConfig(tiers=t_parse("3x2:H=2")),
                sim_cfg=TSimConfig(scenario="custom"), topo=topo,
                fleet=TFleet(topo, 4, seed=0), lp=TLP(model_params=1e5))


def test_manhattan_replays_the_reference_timeline():
    """Street-grid trace replay under the deadline discipline with ``move``
    residency: the lockstep loop's gathered batches and residency-aware
    round pricing."""
    jtrace, ttrace, gap, tstate = _run_both("manhattan")
    _check_same_run(jtrace, ttrace, gap, tstate)
    assert ttrace.meta["trace_replay"] and ttrace.meta["residency"] == "move"


@pytest.mark.parametrize("policy", ["duplicate", "stale"])
def test_trace_file_and_residency_overrides_replay_the_reference(tmp_path, policy):
    """``build_engine(trace_file=, residency=)``, the train CLI's
    ``--trace-in``/``--residency``: a saved trace replaces the scenario's
    mobility (``mobility``'s waypoint speed is silenced) on both sides."""
    path = tmp_path / "walk.csv"
    ttr.generate("random-waypoint", 4, 300.0, seed=3, speed_mps=40.0).save(str(path))
    jtrace, ttrace, gap, tstate = _run_both("mobility", trace_file=str(path),
                                            residency=policy)
    _check_same_run(jtrace, ttrace, gap, tstate)
    assert ttrace.meta["residency"] == policy and ttrace.meta["trace_replay"]
