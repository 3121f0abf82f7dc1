"""Depth > 2 on the port against the reference: the tiered cascade
(``HierSyncStep``), the unit scheduler's within-unit syncs and pushes, the
hier probe, the leaf layout and the in-sync statistics, the unit scheduler
end to end, and the reference's rejections.

Tolerances:
  * the syncs are BITWISE the reference's jitted programs (params, w_ref,
    eps, e and every ``HierBufs`` row after each call), for topk/hist/
    pallas Ω x f32/bf16/q8 wire, fanouts 2 and 3 (a fanout of 3 makes the
    f32 reciprocal of the group mean and the drift's fma round), depths 3
    and 4. The trees are model trees (the tiny f32 transformer and the
    narrow bf16 olmo): on toy trees of a few small leaves XLA fuses the
    root's δ the other way round, fma(β_down, e, Σ·(1/G)) instead of
    fma(Σ, 1/G, β_down·e) (ROADMAP Queue 3);
  * the probe's device bit counts equal the reference probe's;
  * statistics: norms rtol 1e-6, index sets equal, the state the same
    with statistics on and off;
  * the async-root tree end to end: the virtual timeline (every row's
    ``t``, ``tier``, ``edge``, ``round``, ``staleness``, ``weight``,
    ``bits_*``) and the meta exactly equal, per-row losses rtol 1e-4 in
    f32 model math (a unit's loss is a mean over 2 clusters only).
"""
import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import accounting as jacc
from repro.configs import get_config
from repro.configs.base import HFLConfig as JHFLConfig
from repro.configs.base import parse_tiers_spec
from repro.core import hfl as jhfl
from repro.core.schedule import run_hfl as j_run_hfl
from repro.launch.steps import make_loss_fn as j_loss_fn
from repro.models.transformer import init_model as j_init
from repro.optim import SGDM as JSGDM
from repro.sim import scenarios as JS
from repro.wireless.latency import LatencyParams as JLP
from repro_torch.comm import accounting as tacc
from repro_torch.configs import HFLConfig as THFLConfig
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import parse_tiers_spec as t_parse
from repro_torch.core import hfl as thfl
from repro_torch.core.schedule import run_hfl as t_run_hfl
from repro_torch.launch.steps import make_loss_fn as t_loss_fn
from repro_torch.optim import SGDM as TSGDM
from repro_torch.sim import scenarios as TS
from repro_torch.utils import flatten as tfl
from repro_torch.utils.convert import state_from_numpy
from repro_torch.utils.tree import tree_leaves
from repro_torch.wireless.latency import LatencyParams as TLP

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_hfl import TINY  # noqa: E402
from test_torch_sim import NARROW, _batches  # noqa: E402

torch.use_deterministic_algorithms(True)
torch.set_num_threads(2)

OLMO = dataclasses.replace(get_config("olmo-1b").reduced(), **NARROW)
MODELS = {"tiny-f32": TINY, "olmo-bf16": OLMO}
WIRES = {"f32": ("sparse", "bf16"), "bf16": ("quantized_sparse", "bf16"),
         "q8": ("quantized_sparse", "q8")}


def _cfgs(fan, impl="topk", wire="f32", **kw):
    """Both packages' configs of a tree with the given fan-outs of tiers
    1.. (bottom-up; 2 MUs per cluster), β = (0.5, 0.3) at every tier
    (0.3 is not a power of two: its products round)."""
    mode, fmt = WIRES[wire]
    tiers = ((2, 1, 0.99, 0.9),) + tuple((f, 2, 0.9, 0.8, 0.5, 0.3) for f in fan)
    kw = dict(tiers=tiers, sync_mode=mode, omega_impl=impl, wire_format=fmt, **kw)
    return JHFLConfig(**kw), THFLConfig(**kw)


def _states(model, fan, impl="topk", wire="f32", seed=0):
    """The reference's hfl_init of ``model`` with every row perturbed and
    tier buffers with distinct references and errors, and the port's copy."""
    jcfg, tcfg = _cfgs(fan, impl, wire)
    state = jhfl.hfl_init(j_init(jax.random.PRNGKey(seed), MODELS[model]),
                          JSGDM(momentum=0.9), jcfg)
    rng = np.random.default_rng(seed)
    noise = lambda shape, sc: (sc * rng.standard_normal(shape)).astype(np.float32)
    perturb = lambda tree, sc: jax.tree.map(lambda p: jnp.asarray(
        (np.asarray(p, np.float32) + noise(p.shape, sc)).astype(p.dtype)), tree)
    state = state._replace(params=perturb(state.params, 0.1),
                           eps=perturb(state.eps, 0.01), e=perturb(state.e, 0.01))
    bufs = jhfl.init_hier_bufs(state, jcfg)
    bufs = jhfl.HierBufs(
        refs=tuple(r + jnp.asarray(noise(r.shape, 0.05)) for r in bufs.refs),
        eps=tuple(jnp.asarray(noise(r.shape, 0.01)) for r in bufs.eps),
        errs=tuple(jnp.asarray(noise(r.shape, 0.01)) for r in bufs.errs))
    tstate = state_from_numpy(jax.tree.map(np.asarray, state), "cpu")
    tbufs = thfl.HierBufs(*(tuple(torch.from_numpy(np.array(x)) for x in f)
                            for f in bufs))
    return jcfg, tcfg, state, bufs, tstate, tbufs


def _bits(a):
    a = a.float().numpy() if torch.is_tensor(a) else np.asarray(a, np.float32)
    return a.view(np.int32)


def _assert_same(tstate, tbufs, jstate, jbufs, what=""):
    for field in ("params", "w_ref", "eps", "e"):
        tl, jl = tree_leaves(getattr(tstate, field)), jax.tree.leaves(getattr(jstate, field))
        assert len(tl) == len(jl)
        for a, b in zip(tl, jl):
            assert str(a.dtype).replace("torch.", "") == str(b.dtype), field
            np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=f"{what} {field}")
    for field in ("refs", "eps", "errs"):
        for i, (a, b) in enumerate(zip(getattr(tbufs, field), getattr(jbufs, field))):
            np.testing.assert_array_equal(_bits(a), _bits(b),
                                          err_msg=f"{what} bufs.{field}[{i}]")


@pytest.mark.parametrize("fan", [(2, 2), (3, 2, 2)])
def test_hier_fire_top_cadence(fan):
    jcfg, tcfg = _cfgs(fan)
    for r in range(1, 25):
        assert thfl.hier_fire_top(tcfg.tiers, r) == jhfl.hier_fire_top(jcfg.tiers, r)
    assert [thfl.hier_fire_top(tcfg.tiers, r) for r in range(1, 5)] == \
        ([1, 2, 1, 2] if len(fan) == 2 else [1, 2, 1, 3])


def test_init_hier_bufs_matches_reference():
    jcfg, tcfg, jstate, _, tstate, _ = _states("tiny-f32", (3, 2, 2))
    jb, tb = jhfl.init_hier_bufs(jstate, jcfg), thfl.init_hier_bufs(tstate, tcfg)
    for field in ("refs", "eps", "errs"):
        got, want = getattr(tb, field), getattr(jb, field)
        assert [tuple(x.shape) for x in got] == [x.shape for x in want]
        for a, b in zip(got, want):
            np.testing.assert_array_equal(_bits(a), _bits(b))


# (model, fan-outs of tiers 1.., top, Ω impl, wire): every impl and wire,
# fanouts 2 and 3 at each boundary, every top of depths 3 and 4
CASCADE = [(m, fan, top, impl, wire)
           for m, fan, cases in (
               ("tiny-f32", (3, 2), (("topk", "f32"), ("hist", "bf16"), ("pallas", "q8"))),
               ("olmo-bf16", (2, 3), (("topk", "q8"), ("hist", "f32"), ("pallas", "bf16"),
                                      ("pallas", "q8"))))
           for impl, wire in cases for top in (1, 2)]
CASCADE += [("tiny-f32", (2, 3, 2), top, impl, wire) for top in (1, 2, 3)
            for impl, wire in (("pallas", "f32"), ("hist", "q8"))]


@pytest.mark.parametrize("model,fan,top,impl,wire", CASCADE,
                         ids=[f"{m}-{'x'.join(map(str, f))}-top{t}-{i}-{w}"
                              for m, f, t, i, w in CASCADE])
def test_cascade_bitwise(model, fan, top, impl, wire):
    jcfg, tcfg, jstate, jbufs, tstate, tbufs = _states(model, fan, impl, wire)
    jstate, jbufs = jhfl.HierSyncStep(jcfg)(jstate, jbufs, top)
    sync = thfl.make_sync(thfl.SyncPlan(tcfg))
    assert sync.hier and isinstance(sync, thfl.HierSyncStep)
    tstate, tbufs = sync(tstate, tbufs, top)
    _assert_same(tstate, tbufs, jstate, jbufs)
    # rows identical below the top boundary's aggregators
    W = thfl._subtree_width(tcfg.tiers, 0, top)
    for P in tree_leaves(tstate.params):
        for n in range(P.shape[0]):
            assert torch.equal(P[n], P[(n // W) * W])


# (fan-outs, Ω impl, wire, cut, [("sync", u, utop) | ("push", t, a, weight)])
UNIT = [((2, 3), "topk", "f32", 2,
         [("sync", 1, 1), ("push", 2, 1, 0.25), ("sync", 0, 1), ("push", 2, 0, 1 / 3)]),
        ((3, 2, 2), "pallas", "q8", 3,
         [("sync", 1, 2), ("push", 3, 1, 0.5), ("sync", 0, 1)]),
        ((2, 3, 2), "hist", "bf16", 2,
         [("sync", 2, 1), ("push", 2, 2, 0.2), ("push", 3, 0, 0.3), ("push", 1, 5, 0.7)])]


@pytest.mark.parametrize("fan,impl,wire,cut,calls", UNIT,
                         ids=[f"{'x'.join(map(str, u[0]))}-{u[1]}-{u[2]}-cut{u[3]}"
                              for u in UNIT])
def test_unit_sync_and_push_bitwise(fan, impl, wire, cut, calls):
    jcfg, tcfg, jstate, jbufs, tstate, tbufs = _states("tiny-f32", fan, impl, wire)
    j_sync, j_push = jhfl.HierSyncStep(jcfg).unit_ops(cut)
    t_sync, t_push = thfl.HierSyncStep(tcfg).unit_ops(cut)
    for call in calls:
        if call[0] == "sync":
            jstate, jbufs = j_sync(jstate, jbufs, *call[1:])
            tstate, tbufs = t_sync(tstate, tbufs, *call[1:])
        else:
            jstate, jbufs = j_push(jstate, jbufs, *call[1:])
            tstate, tbufs = t_push(tstate, tbufs, *call[1:])
        _assert_same(tstate, tbufs, jstate, jbufs, str(call))


def test_unit_ops_reject_a_cut_out_of_range():
    for mod, cfg in ((jhfl, _cfgs((2, 2))[0]), (thfl, _cfgs((2, 2))[1])):
        with pytest.raises(ValueError, match="out of range"):
            mod.HierSyncStep(cfg).unit_ops(3)


# ---------------------------------------------------------------------------
# The hier probe
# ---------------------------------------------------------------------------


def _snapshot(state, bufs):
    rows = [tfl.pack_stacked(state.params)[0], tfl.pack(state.w_ref)[0],
            tfl.pack_stacked(state.eps)[0], tfl.pack(state.e)[0], *bufs.refs,
            *bufs.eps, *bufs.errs]
    return [r.float().view(torch.int32).clone() for r in rows]


@pytest.mark.parametrize("codec", ["dense-f32", "dense-bf16", "bitmap", "bitmap-q8"])
def test_hier_probe_bits_match_reference(codec):
    """The cheap codecs on every payload of a depth-4 cascade to the root."""
    jcfg, tcfg, jstate, jbufs, tstate, tbufs = _states("tiny-f32", (2, 3, 2),
                                                       "pallas", "q8")
    juls, jdls = jacc.make_hier_sync_probe(jcfg, codec)(jstate, jbufs, 3)
    before = _snapshot(tstate, tbufs)
    tuls, tdls = tacc.make_hier_sync_probe(tcfg, codec)(tstate, tbufs, 3)
    assert [tuple(u.shape) for u in tuls] == [(12,), (6,), (2,)]
    for got, want in zip(tuls + tdls, juls + jdls):
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for a, b in zip(_snapshot(tstate, tbufs), before):  # nothing changed
        assert torch.equal(a, b)


def test_hier_probe_every_codec_matches_reference():
    """Every codec on the boundary-1 probe of a depth-3 tree."""
    from repro_torch.comm.codecs import CODECS

    jcfg, tcfg, jstate, jbufs, tstate, tbufs = _states("olmo-bf16", (2, 3), "hist", "bf16")
    for codec in CODECS:
        juls, jdls = jacc.make_hier_sync_probe(jcfg, codec)(jstate, jbufs, 1)
        tuls, tdls = tacc.make_hier_sync_probe(tcfg, codec)(tstate, tbufs, 1)
        for got, want in zip(tuls + tdls, juls + jdls):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=codec)


@pytest.mark.parametrize("impl,wire", [("topk", "f32"), ("pallas", "q8")])
def test_the_cascade_sends_the_probed_payloads(impl, wire):
    """The top-2 cascade on the state the probe read sends what the probe
    found: the root's new w_ref is the old one plus its probed downlink,
    and the probe's bits are the host counts of its payloads."""
    from repro_torch.comm.codecs import get_codec

    _, tcfg, _, _, tstate, tbufs = _states("olmo-bf16", (2, 3), impl, wire)
    codec, Q = get_codec("delta-varint"), tfl.spec_of(tstate.w_ref).total
    ups, downs = [], []
    thfl.hier_payloads(tcfg, tstate, tbufs, 2,
                       on_up=lambda t, v, i: ups.append((t, v, i)),
                       on_down=lambda t, v, i: downs.append((t, v, i)))
    assert [t for t, _, _ in ups] == [1] * 6 + [2] * 3
    assert [t for t, _, _ in downs] == [1, 1, 1, 2]
    uls, dls = tacc.make_hier_sync_probe(tcfg, codec)(tstate, tbufs, 2)
    assert torch.cat(uls).tolist() == [codec.measure_bits(v, i, Q) for _, v, i in ups]
    assert torch.cat(dls).tolist() == [codec.measure_bits(v, i, Q) for _, v, i in downs]
    wref0 = tfl.pack(tstate.w_ref)[0].clone()
    tstate, tbufs = thfl.HierSyncStep(tcfg)(tstate, tbufs, 2)
    _, dv, di = downs[-1]
    want = wref0.index_add_(0, di.long(), dv)
    assert torch.equal(tfl.pack(tstate.w_ref)[0].view(torch.int32), want.view(torch.int32))


# ---------------------------------------------------------------------------
# The leaf layout and the in-sync statistics
# ---------------------------------------------------------------------------


def _depth2(model, N, **kw):
    jcfg = JHFLConfig(tiers=((2, 1, 0.99, 0.9), (N, 2, 0.9, 0.8, 0.5, 0.3)), **kw)
    tcfg = THFLConfig(tiers=((2, 1, 0.99, 0.9), (N, 2, 0.9, 0.8, 0.5, 0.3)), **kw)
    state = jhfl.hfl_init(j_init(jax.random.PRNGKey(1), MODELS[model]),
                          JSGDM(momentum=0.9), jcfg)
    rng = np.random.default_rng(1)
    perturb = lambda tree, sc: jax.tree.map(lambda p: jnp.asarray(
        (np.asarray(p, np.float32)
         + sc * rng.standard_normal(p.shape).astype(np.float32)).astype(p.dtype)), tree)
    state = state._replace(params=perturb(state.params, 0.1),
                           eps=perturb(state.eps, 0.01), e=perturb(state.e, 0.01))
    return jcfg, tcfg, state, state_from_numpy(jax.tree.map(np.asarray, state), "cpu")


@pytest.mark.parametrize("model,N,wire", [("olmo-bf16", 2, "f32"), ("tiny-f32", 3, "bf16"),
                                          ("olmo-bf16", 3, "q8")])
def test_leaf_sync_bitwise(model, N, wire):
    mode, fmt = WIRES[wire]
    jcfg, tcfg, jstate, tstate = _depth2(model, N, sync_mode=mode, wire_format=fmt,
                                         sync_layout="leaf")
    jnew = jhfl.jit_sync_step(jhfl.make_sync(jhfl.SyncPlan.from_config(jcfg)))(jstate)
    tnew = thfl.make_sync(thfl.SyncPlan(tcfg))(tstate)
    _assert_same(tnew, thfl.HierBufs((), (), ()), jnew, jhfl.HierBufs((), (), ()))


@pytest.mark.parametrize("mode,impl", [("dense", "topk"), ("sparse", "topk"),
                                       ("sparse", "pallas"), ("sparse", "fused")])
def test_collect_stats_match_reference(mode, impl):
    jcfg, tcfg, jstate, tstate = _depth2("tiny-f32", 3, sync_mode=mode, omega_impl=impl)
    _, _, _, tplain = _depth2("tiny-f32", 3, sync_mode=mode, omega_impl=impl)
    jsync = jhfl.jit_sync_step(jhfl.make_sync(
        jhfl.SyncPlan.from_config(jcfg, collect_stats=True)))
    jnew, jstats = jsync(jstate)
    tsync = thfl.make_sync(thfl.SyncPlan(tcfg, collect_stats=True))
    assert tsync.collect_stats
    tnew, tstats = tsync(tstate)
    assert set(tstats) == set(jstats)
    for k, want in jstats.items():
        got = tstats[k].numpy()
        if k.endswith("_idx"):
            np.testing.assert_array_equal(got, np.asarray(want), err_msg=k)
        else:
            np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6, err_msg=k)
    # the state is the same with the statistics on and off
    plain = thfl.make_sync(thfl.SyncPlan(tcfg))(tplain)
    empty = thfl.HierBufs((), (), ())
    _assert_same(tnew, empty, jnew, empty)
    for a, b in zip(_snapshot(tnew, empty), _snapshot(plain, empty)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# Rejections, each as the reference raises it
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw,match", [
    ({"omega_impl": "fused"}, "depth-2 only"),
    ({"sync_mode": "dense"}, "sparse consensus only"),
    ({"sync_layout": "leaf"}, "flat layout only"),
])
def test_depth3_rejections(kw, match):
    jcfg, tcfg = _cfgs((2, 2))
    for mod, cfg in ((jhfl, jcfg), (thfl, tcfg)):
        with pytest.raises(ValueError, match=match):
            mod.make_sync(mod.SyncPlan(dataclasses.replace(cfg, **kw)))
    for mod, cfg in ((jhfl, jcfg), (thfl, tcfg)):
        with pytest.raises(ValueError, match="collect_stats"):
            mod.make_sync(mod.SyncPlan(cfg, collect_stats=True))


def _scenario_cfgs(tier_disc=(), accounting="analytic"):
    """Both packages' hier-3tier configs with per-tier disciplines set."""
    out = []
    for S, HC in ((JS, JHFLConfig), (TS, THFLConfig)):
        scn = S.get_scenario("hier-3tier")
        hfl = S.apply_hfl_overrides(scn, HC(payload_accounting=accounting))
        tiers = list(hfl.tiers)
        for t, disc in tier_disc:
            tiers[t] = dataclasses.replace(tiers[t], discipline=disc)
        out.append((S, scn, dataclasses.replace(hfl, tiers=tuple(tiers))))
    return out


def _small_state(hfl, torch_side):
    params = {"w": jnp.zeros((8, 4)), "b": jnp.zeros((4,))}
    state = jhfl.hfl_init(params, JSGDM(momentum=0.0), hfl)
    return state_from_numpy(jax.tree.map(np.asarray, state), "cpu") if torch_side else state


@pytest.mark.parametrize("tier_disc,accounting,residency,match", [
    (((2, "deadline"),), "analytic", None, "boundary 1 only"),
    (((1, "async"),), "analytic", None, "contiguous top suffix"),
    (((2, "async"),), "measured", None, "measured"),
    (((2, "async"),), "analytic", "move", "residency"),
    (((1, "deadline"), (2, "async")), "analytic", None, "deadline boundary below"),
])
def test_engine_rejections(tier_disc, accounting, residency, match):
    for S, scn, hfl in _scenario_cfgs(tier_disc, accounting):
        torch_side = S is TS
        eng = S.build_engine(scn, hfl, lp=(TLP if torch_side else JLP)(model_params=1e5),
                             seed=0, residency=residency)
        sync = (thfl if torch_side else jhfl).make_sync(
            (thfl if torch_side else jhfl).SyncPlan(hfl))
        with pytest.raises(ValueError, match=match):
            eng.run(_small_state(hfl, torch_side), lambda s, b, keep=None: (s, None),
                    sync, iter(()), 4)


# ---------------------------------------------------------------------------
# The unit scheduler end to end
# ---------------------------------------------------------------------------


def _engine_both(tiers_spec=None, scenario=None, steps=8):
    """The async-root tree through both packages from the same converted
    init and batches, in f32 model math -> (reference result, port result)
    each (state, per-row losses, trace or None): through ``run_hfl`` (null
    wireless) for a ``tiers_spec``, else through the ``scenario``'s engine
    with its root tier made async."""
    jm = dataclasses.replace(OLMO, dtype="float32")
    tm = dataclasses.replace(t_get_config("olmo-1b").reduced(), **NARROW, dtype="float32")
    if scenario is None:
        jh = JHFLConfig(tiers=parse_tiers_spec(tiers_spec))
        th = THFLConfig(tiers=t_parse(tiers_spec))
    else:
        (_, jscn, jh), (_, tscn, th) = _scenario_cfgs(((2, "async"),))
    N, local_b = th.num_clusters, th.mus_per_cluster * 2
    jopt = JSGDM(momentum=0.9, weight_decay=1e-4)
    jstate = jhfl.hfl_init(j_init(jax.random.PRNGKey(0), jm), jopt, jh)
    tstate = state_from_numpy(jax.tree.map(np.asarray, jstate), "cpu")
    sched = lambda t: 0.05
    out = []
    for side in ("ref", "port"):
        losses = []
        on_step = lambda t, s, loss: losses.append(np.asarray(
            loss.float().numpy() if torch.is_tensor(loss) else loss, np.float64))
        if side == "ref":
            train = jax.jit(jhfl.make_cluster_train_step(j_loss_fn(jm), jopt, sched))
            sync = jhfl.make_sync(jhfl.SyncPlan.from_config(jh))
            batches = ({"tokens": jnp.asarray(b)}
                       for b in _batches(jm.vocab_size, N, local_b))
            state = jstate
        else:
            topt = TSGDM(momentum=0.9, weight_decay=1e-4)
            train = thfl.make_cluster_train_step(t_loss_fn(tm), topt, sched)
            sync = thfl.make_sync(thfl.SyncPlan(th))
            batches = ({"tokens": torch.from_numpy(b).long()}
                       for b in _batches(tm.vocab_size, N, local_b))
            state = tstate
        if scenario is None:
            run = j_run_hfl if side == "ref" else t_run_hfl
            state = run(state, train, sync, batches, 2, steps, on_step=on_step)
            trace = None
        else:
            S, scn, hfl = (JS, jscn, jh) if side == "ref" else (TS, tscn, th)
            LP = JLP if side == "ref" else TLP
            eng = S.build_engine(scn, hfl, lp=LP(M=32, model_params=1e6), seed=0)
            state, trace = eng.run(state, train, sync, batches, steps, on_step=on_step)
        out.append((state, losses, trace))
    return out


def test_async_root_through_run_hfl_matches_reference():
    """``--tiers 2x2x2:H=2,2:async`` without a radio: 2 units of 2
    clusters, 4 rounds each; the unit losses follow the reference's."""
    (js, jl, _), (ts, tl, _) = _engine_both("2x2x2:H=2,2:async")
    assert len(tl) == len(jl) == 2 * 4
    np.testing.assert_allclose(np.concatenate(tl), np.concatenate(jl), rtol=1e-4)
    jw = np.concatenate([np.asarray(x, np.float32).ravel() for x in jax.tree.leaves(js.w_ref)])
    tw = tfl.pack(ts.w_ref)[0].numpy()
    np.testing.assert_allclose(tw, jw, rtol=1e-4, atol=1e-6)


def test_async_root_scenario_timeline_matches_reference():
    """hier-3tier with an async root on the radio: every unit sync and push
    row's virtual time, staleness, weight and bits exactly the reference's."""
    (_, jl, jtrace), (_, tl, ttrace) = _engine_both(scenario="hier-3tier")
    assert ttrace.meta == jtrace.meta and ttrace.meta["hier_depth"] == 3
    assert len(ttrace.rows) == len(jtrace.rows) > 0
    for jr, tr in zip(jtrace.rows, ttrace.rows):
        assert set(tr) == set(jr)
        assert {k: v for k, v in tr.items() if k != "loss"} == \
            {k: v for k, v in jr.items() if k != "loss"}
    np.testing.assert_allclose([r["loss"] for r in ttrace.rows if "loss" in r],
                               [r["loss"] for r in jtrace.rows if "loss" in r],
                               rtol=1e-4)
    pushes = [r for r in ttrace.rows if "staleness" in r]
    assert pushes and all(0.0 < r["weight"] <= 0.5 for r in pushes)
