"""The port's copies of the simulator's numpy layers against the
reference: ``wireless`` (qam, subcarrier, topology, broadcast, latency),
``sim.devices``, ``sim.selection`` and ``sim.events``. The same seeds and
inputs give bit-identical arrays (``np.array_equal``, floats compared
exactly): the simulator's virtual clock is built from them.

Radios are small (M of 12-40 sub-carriers, payloads of 1e5-1e6 bits) so
Alg. 2's greedy loop and the broadcast Monte-Carlo stay fast.
"""
import numpy as np
import pytest

from repro.configs.base import HFLConfig as JHFL
from repro.configs.base import SimConfig as JSim
from repro.configs.base import parse_tiers_spec as j_parse
from repro.sim import devices as jdev
from repro.sim import events as jev
from repro.sim import selection as jsel
from repro.wireless import broadcast as jbc
from repro.wireless import latency as jlat
from repro.wireless import qam as jqam
from repro.wireless import subcarrier as jsub
from repro.wireless import topology as jtop
from repro_torch.configs import HFLConfig as THFL
from repro_torch.configs import SimConfig as TSim
from repro_torch.configs import parse_tiers_spec
from repro_torch.sim import devices as tdev
from repro_torch.sim import events as tev
from repro_torch.sim import selection as tsel
from repro_torch.wireless import broadcast as tbc
from repro_torch.wireless import latency as tlat
from repro_torch.wireless import qam as tqam
from repro_torch.wireless import subcarrier as tsub
from repro_torch.wireless import topology as ttop

RADIO = dict(B0=30e3, Pmax=0.2, N0=10.0 ** (-150.0 / 10.0) / 30e3, alpha=2.8,
             ber=1e-3)


def _same(a, b):
    """Bit-identical: equal values, dtypes and shapes, NaNs in place."""
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _same(a[k], b[k])
        return
    if isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f")


@pytest.mark.parametrize("chunk", [None, 7])
def test_qam_rates(chunk):
    d = np.random.default_rng(0).uniform(1.0, 800.0, 40)
    x = np.concatenate([np.linspace(1e-6, 3.0, 50), [0.0, 1.0, 25.0]])
    _same(tqam.exp_integral_e1(x), jqam.exp_integral_e1(x))
    for m in (1, 3):
        _same(tqam.optimal_rate_vec(d, m=m, chunk=chunk, **RADIO),
              jqam.optimal_rate_vec(d, m=m, chunk=chunk, **RADIO))
    for dd in d[:5]:
        _same(tqam.optimal_rate_per_subcarrier(m=2, d=dd, **RADIO),
              jqam.optimal_rate_per_subcarrier(m=2, d=dd, **RADIO))


def test_subcarrier_allocation_and_reclaim():
    d = np.random.default_rng(1).uniform(20.0, 250.0, 5)
    _same(tsub.allocate_subcarriers(d, 14, **RADIO),
          jsub.allocate_subcarriers(d, 14, **RADIO))
    _same(tsub.min_rate(d, 12, **RADIO), jsub.min_rate(d, 12, **RADIO))
    _same(tsub.user_rate(3, 100.0, **RADIO), jsub.user_rate(3, 100.0, **RADIO))
    alive = np.array([1, 0, 1, 1, 0], bool)
    _same(tsub.reallocate_after_drop(d, alive, 12, **RADIO),
          jsub.reallocate_after_drop(d, alive, 12, **RADIO))


@pytest.mark.parametrize("n_clusters,mpc,reuse", [(7, 3, 1), (4, 2, 7)])
def test_topology(n_clusters, mpc, reuse):
    _same(ttop.uniform_disk(np.random.default_rng(4), 9, 30.0, (1.0, 2.0)),
          jtop.uniform_disk(np.random.default_rng(4), 9, 30.0, (1.0, 2.0)))
    _same(ttop.hex_centers(), jtop.hex_centers())
    tt = ttop.HCNTopology(num_clusters=n_clusters, seed=5)
    jt = jtop.HCNTopology(num_clusters=n_clusters, seed=5)
    (tp, tc), (jp, jc) = tt.drop_users(mpc), jt.drop_users(mpc)
    _same((tp, tc), (jp, jc))
    _same(tt.dist_to_mbs(tp), jt.dist_to_mbs(jp))
    _same(tt.dist_to_sbs(tp, tc), jt.dist_to_sbs(jp, jc))
    _same(tt.coloring(reuse), jt.coloring(reuse))


def test_broadcast_latency():
    d = np.array([40.0, 120.0, 230.0])
    for bits in (0.0, 2e5, 1e6):
        _same(tbc.broadcast_latency(d, bits, M=12, B0=30e3, Pmax=6.3,
                                    N0=RADIO["N0"], alpha=2.8,
                                    rng=np.random.default_rng(6), trials=3),
              jbc.broadcast_latency(d, bits, M=12, B0=30e3, Pmax=6.3,
                                    N0=RADIO["N0"], alpha=2.8,
                                    rng=np.random.default_rng(6), trials=3))


def test_latency_params_and_tier_payloads():
    for kw in ({}, {"model_params": 1e6, "bits_per_param": 16.0},
               {"index_bits": 5.0}):
        t, j = tlat.LatencyParams(**kw), jlat.LatencyParams(**kw)
        _same(t.n0, j.n0)
        for phi in (0.0, 0.9, 0.99):
            _same(t.payload(phi), j.payload(phi))
    _same(tlat.tier_payload_bits(tlat.LatencyParams(),
                                 parse_tiers_spec("3x2x2:H=2"), {"sbs_ul": 7.0}),
          jlat.tier_payload_bits(jlat.LatencyParams(), j_parse("3x2x2:H=2"),
                                 {"sbs_ul": 7.0}))


@pytest.mark.parametrize("single", [False, True])
@pytest.mark.parametrize("overrides", [None, {"mu_ul": 3e5, "mbs_dl": 2e5}])
def test_fl_and_hfl_latency(single, overrides):
    lp_t, lp_j = (m.LatencyParams(M=40, model_params=2e5) for m in (tlat, jlat))
    topo_t, topo_j = ttop.HCNTopology(num_clusters=4, seed=2), \
        jtop.HCNTopology(num_clusters=4, seed=2)
    pos, cid = topo_t.drop_users(3)
    topo_j.drop_users(3)
    cid = cid.copy()
    cid[cid == 3] = 1  # an empty cluster (mobility can empty one)
    suffix = "_single" if single else ""
    kw = dict(phi_ul=0.9, phi_dl=0.5)
    if overrides:
        kw.update(ul_bits=overrides["mu_ul"], dl_bits=overrides["mbs_dl"])
    _same(getattr(tlat, "fl_latency" + suffix)(topo_t, pos, lp_t, **kw),
          getattr(jlat, "fl_latency" + suffix)(topo_j, pos, lp_j, **kw))
    kw = dict(H=2, phi_mu_ul=0.99, phi_sbs_dl=0.9, phi_sbs_ul=0.9,
              phi_mbs_dl=0.9, payload_bits=overrides)
    (tp, ta) = getattr(tlat, "hfl_latency" + suffix)(topo_t, pos, cid, lp_t, **kw)
    (jp, ja) = getattr(jlat, "hfl_latency" + suffix)(topo_j, pos, cid, lp_j, **kw)
    _same(tp, jp)
    _same(ta, ja)


def _fleets(**kw):
    return (tdev.DeviceFleet(ttop.HCNTopology(num_clusters=5, seed=3), 3, **kw),
            jdev.DeviceFleet(jtop.HCNTopology(num_clusters=5, seed=3), 3, **kw))


@pytest.mark.parametrize("kw", [
    dict(compute_sigma=1.0, dropout=0.3, seed=7),
    dict(dropout=0.3, diurnal_amp=0.9, diurnal_period_s=240.0,
         diurnal_phase=0.75, seed=1),
    dict(speed_mps=30.0, compute_sigma=0.5, seed=2),
], ids=["stragglers+dropout", "diurnal", "mobility"])
def test_device_fleet_replays(kw):
    tf, jf = _fleets(**kw)
    _same((tf.pos, tf.cid, tf.compute_mult), (jf.pos, jf.cid, jf.compute_mult))
    for r in range(4):
        t = 37.0 * r
        _same(tf.unavailability(t), jf.unavailability(t))
        _same(tf.draw_available(t), jf.draw_available(t))
        tf.advance(9.0)
        jf.advance(9.0)
        _same(tf.reassociate(), jf.reassociate())
        _same(tf.pos, jf.pos)
        _same(tf.compute_times(0.05), jf.compute_times(0.05))
        _same(tf.cluster_sizes(), jf.cluster_sizes())
        _same(tf.cluster_comp_max(0.05), jf.cluster_comp_max(0.05))
        _same(tf.cluster_members_csr(), jf.cluster_members_csr())
        _same(tf.cluster_members(1), jf.cluster_members(1))
    assert tf.mobile == jf.mobile


def test_waypoint_step_and_trace_replay_raises():
    rng_t, rng_j = np.random.default_rng(8), np.random.default_rng(8)
    pos = np.random.default_rng(9).uniform(-100, 100, (6, 2))
    wp = np.random.default_rng(10).uniform(-100, 100, (6, 2))
    budget = np.linspace(0.0, 900.0, 6)
    _same(tdev.waypoint_step(pos.copy(), wp.copy(), budget.copy(), rng_t, 750.0),
          jdev.waypoint_step(pos.copy(), wp.copy(), budget.copy(), rng_j, 750.0))
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 12"):
        tdev.DeviceFleet(ttop.HCNTopology(seed=0), 2, trace=object())


@pytest.mark.parametrize("policy,prate", [("uniform", 0.5), ("biased", 0.5),
                                          ("kmeans", 0.4), ("uniform", 1.0)])
def test_client_selection(policy, prate):
    t_hfl, j_hfl = THFL(tiers=parse_tiers_spec("5x3:H=2")), \
        JHFL(num_clusters=5, mus_per_cluster=3, period=2)
    t_sim = TSim(prate=prate, selection=policy, seed=4)
    j_sim = JSim(prate=prate, selection=policy, seed=4)
    ts, js = tsel.make_selector(t_hfl, t_sim), jsel.make_selector(j_hfl, j_sim)
    assert (ts is None) == (js is None)
    if ts is None:  # the identity: no selector, no RNG stream
        return
    tf, jf = _fleets(compute_sigma=0.7, dropout=0.2, seed=5)
    for r in range(3):
        avail_t, avail_j = tf.draw_available(), jf.draw_available()
        _same(ts.select(avail_t, tf, float(r)), js.select(avail_j, jf, float(r)))
    _same(ts.cap(7), js.cap(7))


def test_event_queue():
    rng = np.random.default_rng(11)
    tq, jq = tev.EventQueue(), jev.EventQueue()
    for i, t in enumerate(np.round(rng.uniform(0, 5, 30), 1)):
        tq.push(t, tev.Event("e", cluster=i, round=i % 3))
        jq.push(t, jev.Event("e", cluster=i, round=i % 3))
    got = [(t, e.cluster, e.round) for t, e in (tq.pop() for _ in range(30))]
    want = [(t, e.cluster, e.round) for t, e in (jq.pop() for _ in range(30))]
    assert got == want and tq.now == jq.now
    with pytest.raises(ValueError):
        tq.push(tq.now - 1.0, tev.Event("late"))
    with pytest.raises(IndexError):
        tq.pop()


def test_scale_sampling_sweep():
    from repro.sim import scenarios as JS
    from repro_torch.sim import scenarios as TS

    _same(TS.run_scale_sampling(TS.SCENARIOS["scale-100k"], n_users=3000,
                                chunk=700),
          JS.run_scale_sampling(JS.SCENARIOS["scale-100k"], n_users=3000,
                                chunk=700))
