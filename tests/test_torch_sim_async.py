"""The simulator's async discipline on the port against the reference:
AdamW's per-cluster step counter, the masked one-cluster train step, the
staleness-weighted per-cluster sync and the ``async``/``trace-replay``
scenarios end to end.

Tolerances:
  * the async sync is BITWISE the reference's jitted step (w_ref, every
    eps row, every params row, e_dl, the codec's bit counts), for dense
    and sparse downlink x every Ω impl x wire f32/bf16/q8: the port forms
    the reference's fma(β_s, eps_n, w_n - w_ref), fma(weight, sent, w_ref)
    with the f32-rounded weight and fma(β_m, e_dl_n, w_ref' - w_n);
  * a train step on bf16 weights: the trained row's loss rtol 1e-4 and its
    gap to the reference's row <= 0.25 of that row's move (the bf16
    tolerances of ``tests/test_torch_slice.py``); every other row bitwise
    unchanged;
  * scenario runs: the virtual timeline (every row's ``t``, ``cluster``,
    ``round``, ``staleness``, ``weight``, ``dropped``, ``bits_*``) and
    the meta EXACTLY equal; per-event losses rtol 1e-4 and each cluster
    row's gap <= 0.25 of its move. An async event's loss is ONE cluster's
    (no mean over clusters to average the frameworks' bf16 rounding out):
    with bf16 weights a single row's loss differs from the reference's by
    about the tolerance itself, so the scenario runs compute in f32, where
    the rounding noise is orders of magnitude below it.
"""
import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.configs.base import HFLConfig as JHFLConfig
from repro.configs.base import parse_tiers_spec
from repro.core import hfl as jhfl
from repro.launch.steps import make_loss_fn as j_loss_fn
from repro.models.transformer import init_model as j_init
from repro.optim import SGDM as JSGDM
from repro.optim import AdamW as JAdamW
from repro.sim import engine as JE
from repro.utils import flatten as jfl
from repro_torch.configs import HFLConfig as THFLConfig
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import parse_tiers_spec as t_parse
from repro_torch.core import hfl as thfl
from repro_torch.launch.steps import make_loss_fn as t_loss_fn
from repro_torch.models.transformer import init_model as t_init
from repro_torch.optim import SGDM as TSGDM
from repro_torch.optim import AdamW as TAdamW
from repro_torch.sim import engine as TE
from repro_torch.sim import scenarios as TS
from repro_torch.utils import flatten as tfl
from repro_torch.utils.convert import state_from_numpy
from repro_torch.utils.tree import tree_leaves, tree_map
from repro_torch.wireless.latency import LatencyParams

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_sim import NARROW, _batches, _run_both  # noqa: E402

torch.use_deterministic_algorithms(True)
torch.set_num_threads(2)

RTOL, ROW_TOL = 1e-4, 0.25
TIMELINE = ("kind", "t", "step", "cluster", "round", "staleness", "weight",
            "dropped", "iter_s", "sync_s", "deadline_s", "bits_sbs_ul",
            "bits_mbs_dl", "bits_sync_bcast")
OPTS = {"sgdm": (lambda: JSGDM(momentum=0.9, weight_decay=1e-4),
                 lambda: TSGDM(momentum=0.9, weight_decay=1e-4)),
        "adamw": (lambda: JAdamW(weight_decay=0.1),
                  lambda: TAdamW(weight_decay=0.1))}


def _cfgs(dtype=None):
    kw = dict(NARROW, **({} if dtype is None else {"dtype": dtype}))
    return (dataclasses.replace(get_config("olmo-1b").reduced(), **kw),
            dataclasses.replace(t_get_config("olmo-1b").reduced(), **kw))


def _train_states(opt_name, N=3):
    """The reference's hfl_init of the narrow olmo at ``N`` clusters with
    the named optimizer, and the port's converted copy."""
    jcfg, tcfg = _cfgs()
    jopt, topt = OPTS[opt_name][0](), OPTS[opt_name][1]()
    hfl = JHFLConfig(tiers=parse_tiers_spec(f"{N}x2:H=2"))
    jstate = jhfl.hfl_init(j_init(jax.random.PRNGKey(0), jcfg), jopt, hfl)
    tstate = state_from_numpy(jax.tree.map(np.asarray, jstate), "cpu")
    return jcfg, tcfg, jopt, topt, jstate, tstate


def _tokens(vocab, shape, seed):
    return np.random.default_rng(seed).integers(0, vocab, shape)


def _bits(x):
    return np.ascontiguousarray(np.asarray(x, np.float32)).view(np.int32)


def _jrow(tree, n):
    """Row n of a reference stacked tree, flat f32."""
    return np.concatenate([np.asarray(x[n], np.float32).ravel()
                           for x in jax.tree.leaves(tree)])


def _trow(tree, n):
    """Row n of a port stacked tree, flat f32."""
    return np.concatenate([x[n].float().numpy().ravel() for x in tree_leaves(tree)])


# ---------------------------------------------------------------------------
# AdamW's step counter, per cluster
# ---------------------------------------------------------------------------


def test_adamw_counter_per_cluster_with_a_sat_out_cluster():
    """Two steps, cluster 1 sitting the first out: the reference's vmapped
    step followed by ``_merge_clusters`` leaves t = [2, 1, 2]; the port's
    ``train_step(keep=)`` must too, and cluster 1's second update must
    use ITS bias corrections (t = 1), not the fleet's."""
    jcfg, tcfg, jopt, topt, jstate, tstate = _train_states("adamw")
    jstep = jax.jit(jhfl.make_cluster_train_step(j_loss_fn(jcfg), jopt,
                                                 lambda s: 1e-3))
    tstep = thfl.make_cluster_train_step(t_loss_fn(tcfg), topt, lambda s: 1e-3)
    r0 = _jrow(jstate.params, 1)
    for i, keep in enumerate(([True, False, True], None)):
        toks = _tokens(jcfg.vocab_size, (3, 4, 16), i)
        new, jl = jstep(jstate, {"tokens": jnp.asarray(toks)})
        jstate = JE._merge_clusters(jstate, new, np.asarray(keep)) if keep else new
        tstate, tl = tstep(tstate, {"tokens": torch.from_numpy(toks).long()},
                           keep=keep)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=RTOL)
    assert np.asarray(jstate.opt["t"]).tolist() == [2, 1, 2]
    assert tstate.opt["t"].tolist() == [2, 1, 2]
    for n in range(3):
        jr, tr = _jrow(jstate.params, n), _trow(tstate.params, n)
        assert np.linalg.norm(tr - jr) <= ROW_TOL * np.linalg.norm(jr - r0)


def test_adamw_counter_crosses_from_the_reference():
    jcfg, tcfg, jopt, topt, jstate, _ = _train_states("adamw")
    jstate = jstate._replace(opt=dict(jstate.opt, t=jnp.asarray([3, 0, 7], jnp.int32)))
    tstate = state_from_numpy(jax.tree.map(np.asarray, jstate), "cpu")
    assert tstate.opt["t"].dtype == torch.int64
    assert tstate.opt["t"].tolist() == [3, 0, 7]
    fresh = thfl.hfl_init(
        {"w": torch.zeros(4, 3)}, TAdamW(), THFLConfig(tiers=t_parse("3x2:H=2")))
    assert fresh.opt["t"].tolist() == [0, 0, 0]


# ---------------------------------------------------------------------------
# The masked (one-cluster) train step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("opt_name", sorted(OPTS))
def test_masked_step_trains_one_row(opt_name):
    """Two masked steps of cluster 1 from the same state: the trained row
    against the reference's ``make_masked_cluster_train_step`` (bf16
    tolerances), every other row's params and moments bitwise as before,
    ``step`` and (AdamW) ``t[1]`` advanced."""
    jcfg, tcfg, jopt, topt, jstate, tstate = _train_states(opt_name)
    jstep = jax.jit(jhfl.make_masked_cluster_train_step(
        j_loss_fn(jcfg), jopt, lambda s: 0.05 if opt_name == "sgdm" else 1e-3))
    tstep = thfl.make_masked_cluster_train_step(
        t_loss_fn(tcfg), topt, lambda s: 0.05 if opt_name == "sgdm" else 1e-3)
    moments = [k for k in ("m", "v") if k in tstate.opt]
    before = [t.clone() for t in tree_leaves(tstate.params)
              + sum((tree_leaves(tstate.opt[k]) for k in moments), [])]
    r0 = _jrow(jstate.params, 1)
    for i in range(2):
        toks = _tokens(jcfg.vocab_size, (4, 16), 10 + i)
        jstate, jl = jstep(jstate, {"tokens": jnp.asarray(toks)}, jnp.int32(1))
        tstate, tl = tstep(tstate, {"tokens": torch.from_numpy(toks).long()}, 1)
        assert tl.dim() == 0
        np.testing.assert_allclose(float(tl), float(jl), rtol=RTOL)
    assert tstate.step == int(jstate.step) == 2
    after = tree_leaves(tstate.params) + sum(
        (tree_leaves(tstate.opt[k]) for k in moments), [])
    as_int = lambda x: x.view(torch.int16 if x.element_size() == 2 else torch.int32)
    for a, b in zip(after, before):
        for n in (0, 2):
            assert torch.equal(as_int(a[n]), as_int(b[n]))
    assert any(not torch.equal(a[1], b[1]) for a, b in zip(after, before))
    if opt_name == "adamw":
        assert tstate.opt["t"].tolist() == np.asarray(jstate.opt["t"]).tolist() \
            == [0, 2, 0]
    jr, tr = _jrow(jstate.params, 1), _trow(tstate.params, 1)
    assert np.linalg.norm(tr - jr) <= ROW_TOL * np.linalg.norm(jr - r0)


# ---------------------------------------------------------------------------
# The per-cluster staleness-weighted sync
# ---------------------------------------------------------------------------


def _sync_states(impl, wire, param_dtype=jnp.float32, N=3, seed=0):
    """A perturbed reference state of a two-leaf tree (Q = 3,372), its
    port copy, and a random e_dl [N, Q] for both."""
    rng = np.random.default_rng(seed)
    mode = "quantized_sparse" if wire else "sparse"
    kw = dict(sync_mode=mode, omega_impl=impl, wire_format=wire or "bf16")
    jh = JHFLConfig(tiers=parse_tiers_spec(f"{N}x2:H=2"), **kw)
    th = THFLConfig(tiers=t_parse(f"{N}x2:H=2"), **kw)
    params = {"a": jnp.asarray(rng.standard_normal((64, 48)), param_dtype),
              "b": {"c": jnp.asarray(rng.standard_normal(300), param_dtype)}}
    st = jhfl.hfl_init(params, JSGDM(), jh)
    noise = lambda p, s: jnp.asarray(
        np.asarray(p, np.float32) + s * rng.standard_normal(p.shape), p.dtype)
    st = st._replace(params=jax.tree.map(lambda p: noise(p, 0.1), st.params),
                     eps=jax.tree.map(lambda p: noise(p, 0.05), st.eps))
    Q = 64 * 48 + 300
    e_dl = jnp.asarray(0.05 * rng.standard_normal((N, Q)), jnp.float32)
    return (jh, th, st, state_from_numpy(jax.tree.map(np.asarray, st), "cpu"),
            e_dl, torch.from_numpy(np.asarray(e_dl).copy()))


SYNC_CASES = [(dl, impl, wire) for dl in (False, True)
              for impl in ("topk", "hist", "pallas", "fused")
              for wire in (None, "bf16", "q8")]


@pytest.mark.parametrize("dl_sparse,impl,wire", SYNC_CASES,
                         ids=[f"{'dl' if d else 'dense'}-{i}-{w or 'f32'}"
                              for d, i, w in SYNC_CASES])
def test_async_sync_bitwise(dl_sparse, impl, wire):
    jh, th, jst, tst, jedl, tedl = _sync_states(impl, wire)
    n, w = 1, JE.async_weight(2, 3)
    jf = JE.make_async_sync_step(jh, dl_sparse=dl_sparse, codec="delta-varint")
    got = {}
    tf = TE.make_async_sync_step(th, dl_sparse=dl_sparse, codec="delta-varint",
                                 on_payloads=lambda m, up, down: got.update(
                                     n=m, up=up, down=down))
    if dl_sparse:
        jst, jedl, jb = jf(jst, jedl, jnp.int32(n), jnp.float32(w))
        tst, tedl, tb = tf(tst, tedl, n, w)
        assert np.array_equal(_bits(jedl), _bits(tedl))
    else:
        jst, jb = jf(jst, jnp.int32(n), jnp.float32(w))
        tst, tb = tf(tst, n, w)
    assert np.array_equal(_bits(jfl.pack(jst.w_ref)[0]), _bits(tfl.pack(tst.w_ref)[0]))
    assert np.array_equal(_bits(jfl.pack_stacked(jst.eps)[0]),
                          _bits(tfl.pack_stacked(tst.eps)[0]))
    assert np.array_equal(_bits(jfl.pack_stacked(jst.params)[0]),
                          _bits(tfl.pack_stacked(tst.params)[0]))
    assert set(tb) == set(jb) == ({"sbs_ul", "mbs_dl"} if dl_sparse else {"sbs_ul"})
    assert all(int(tb[k]) == int(jb[k]) for k in jb)
    assert got["n"] == n and (got["down"] is not None) == dl_sparse


@pytest.mark.parametrize("dl_sparse", [False, True])
def test_async_sync_bf16_params_and_in_place(dl_sparse):
    """bf16 cluster rows (the model's dtype): row n rounds once from f32;
    the port's w_ref/eps buffers and e_dl are updated in place."""
    jh, th, jst, tst, jedl, tedl = _sync_states("pallas", None,
                                                param_dtype=jnp.bfloat16, seed=3)
    n, w = 2, JE.async_weight(0, 3)
    wref_ptr = tfl.backing(tst.w_ref, tfl.spec_of(tst.w_ref)).data_ptr()
    jf = JE.make_async_sync_step(jh, dl_sparse=dl_sparse)
    tf = TE.make_async_sync_step(th, dl_sparse=dl_sparse)
    if dl_sparse:
        jst, jedl = jf(jst, jedl, jnp.int32(n), jnp.float32(w))
        tst, tedl2 = tf(tst, tedl, n, w)
        assert tedl2 is tedl and np.array_equal(_bits(jedl), _bits(tedl))
    else:
        jst = jf(jst, jnp.int32(n), jnp.float32(w))
        tst = tf(tst, n, w)
    assert tfl.backing(tst.w_ref, tfl.spec_of(tst.w_ref)).data_ptr() == wref_ptr
    for a, b in zip(jax.tree.leaves(jst.params), tree_leaves(tst.params)):
        assert b.dtype == torch.bfloat16
        assert np.array_equal(np.asarray(a, np.float32), b.float().numpy())
    assert np.array_equal(_bits(jfl.pack(jst.w_ref)[0]), _bits(tfl.pack(tst.w_ref)[0]))


def test_async_weight_and_dl_error_match_reference():
    for s, N, e in ((0, 2, 1.0), (3, 7, 1.0), (5, 4, 0.5), (1, 3, 2.0)):
        assert TE.async_weight(s, N, e) == JE.async_weight(s, N, e)
    _, th, _, tst, _, _ = _sync_states("topk", None)
    e = TE.init_dl_error(tst, th)
    assert e.shape == (3, 64 * 48 + 300) and e.dtype == torch.float32
    assert not e.any()


STATS_CASES = [(dl, impl, codec) for dl in (False, True)
               for impl in ("topk", "pallas") for codec in (None, "delta-varint")]


@pytest.mark.parametrize("dl_sparse,impl,codec", STATS_CASES,
                         ids=[f"{'dl' if d else 'dense'}-{i}-{c or 'nocodec'}"
                              for d, i, c in STATS_CASES])
def test_async_collect_stats_match_reference(dl_sparse, impl, codec):
    """The health monitor's per-cluster statistics of the async sync: the
    Ω index sets exactly, the norms (drift over the post-sync rows, eps,
    w_ref, weight·sent, e_dl) rtol 1e-4 (the port sums them in f64, the
    reference in f32), and the state, e_dl and bit counts bitwise those of
    the same sync without statistics."""
    jh, th, jst, tst, jedl, tedl = _sync_states(impl, None, seed=5)
    _, _, _, tst_off, _, tedl_off = _sync_states(impl, None, seed=5)
    n, w = 2, JE.async_weight(1, 3)
    jf = JE.make_async_sync_step(jh, dl_sparse=dl_sparse, codec=codec,
                                 collect_stats=True)
    tf = TE.make_async_sync_step(th, dl_sparse=dl_sparse, codec=codec,
                                 collect_stats=True)
    off = TE.make_async_sync_step(th, dl_sparse=dl_sparse, codec=codec)
    assert tf.collect_stats and not off.collect_stats
    if dl_sparse:
        jout = jf(jst, jedl, jnp.int32(n), jnp.float32(w))
        tout = tf(tst, tedl, n, w)
        oout = off(tst_off, tedl_off, n, w)
        assert np.array_equal(_bits(tout[1]), _bits(oout[1]))
    else:
        jout = jf(jst, jnp.int32(n), jnp.float32(w))
        tout = tf(tst, n, w)
        oout = off(tst_off, n, w)
        if codec is None:
            oout = (oout,)
    assert len(tout) == len(jout) == len(oout) + 1
    js, ts = jout[-1], tout[-1]
    keys = {"drift", "eps_norm", "wref_norm", "update_norm", "ul_idx"}
    if dl_sparse:
        keys |= {"e_dl_norm", "dl_idx"}
    assert set(ts) == set(js) == keys
    for k in keys:
        if k.endswith("idx"):
            assert np.array_equal(ts[k].long().numpy(), np.asarray(js[k]))
        else:
            assert ts[k].dim() == 0
            np.testing.assert_allclose(float(ts[k]), float(js[k]), rtol=RTOL)
    assert float(ts["drift"]) > 0 and float(ts["update_norm"]) > 0
    for a, b in zip(tree_leaves(tout[0]._asdict()), tree_leaves(oout[0]._asdict())):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))
    if codec is not None:
        assert {k: int(v) for k, v in tout[-2].items()} == \
            {k: int(v) for k, v in oout[-1].items()}


# ---------------------------------------------------------------------------
# Scenarios end to end
# ---------------------------------------------------------------------------


def check_async_run(jtrace, ttrace, gap, rows):
    """Timeline and meta exact, per-event losses rtol 1e-4, every row and
    w_ref within 0.25 of its move."""
    assert ttrace.meta == jtrace.meta
    assert len(ttrace.rows) == len(jtrace.rows) > 0
    for jr, tr in zip(jtrace.rows, ttrace.rows):
        assert set(tr) == set(jr)
        assert {k: tr[k] for k in TIMELINE if k in tr} == \
            {k: jr[k] for k in TIMELINE if k in jr}
    jl = [r["loss"] for r in jtrace.rows if "loss" in r]
    tl = [r["loss"] for r in ttrace.rows if "loss" in r]
    assert jl
    np.testing.assert_allclose(tl, jl, rtol=RTOL)
    assert gap <= ROW_TOL and max(rows) <= ROW_TOL


@pytest.mark.parametrize("name,masked", [("async", True), ("async", False),
                                         ("trace-replay", True),
                                         ("trace-replay", False)])
def test_async_scenarios_replay_the_reference(name, masked):
    """Through both ``build_engine``s and ``SimEngine.run``: with the masked
    step on both sides, and without (the reference's vmapped step and
    ``_take_cluster_row``, the port's ``train_step(keep=one-hot)``)."""
    jtrace, ttrace, gap, _, rows = _run_both(name, masked=masked,
                                             dtype="float32", row_gaps=True)
    check_async_run(jtrace, ttrace, gap, rows)
    syncs = [r for r in ttrace.rows if r["kind"] == "sync"]
    assert syncs and all(r["weight"] == JE.async_weight(r["staleness"], 2)
                         for r in syncs)
    if name == "trace-replay":
        assert ttrace.meta["trace_replay"] and ttrace.meta["residency"] == "move"


def test_async_measured_accounting_replays_the_reference():
    """Measured bits from the async sync's own device counts: the bitmap
    codec's stream length depends on k and Q only, so the ledger is exact
    across the packages."""
    jtrace, ttrace, gap, _, rows = _run_both(
        "async", accounting="measured", codec="bitmap", masked=True,
        dtype="float32", row_gaps=True)
    assert ttrace.meta["payload_accounting"] == "measured"
    assert ttrace.meta["events_sbs_ul"] == ttrace.meta["sync_launches"] > 0
    check_async_run(jtrace, ttrace, gap, rows)


def test_engine_hands_each_event_to_the_hook():
    """``on_async_sync``: one call per synced event, after its sync, with
    the payloads the sync sent (sparse DL: the row moved by exactly the
    received payload)."""
    _, tcfg = _cfgs("float32")
    scn = TS.get_scenario("async")
    hfl = TS.apply_hfl_overrides(scn, THFLConfig(tiers=t_parse("2x2:H=2")))
    rng = np.random.default_rng(0)
    params = tree_map(lambda m: torch.from_numpy((0.02 * rng.standard_normal(
        tuple(m.shape))).astype(np.float32)), t_init(None, tcfg, device="meta"))
    state = thfl.hfl_init(params, TSGDM(momentum=0.9), hfl)
    events, last = [], {}

    def masked(inner):
        def step(st, batch_n, n):
            st, loss = inner(st, batch_n, n)
            last["row"] = tfl.pack_stacked(st.params)[0][n].clone()
            return st, loss
        return step

    def hook(event, st):
        vals, idx = event["downlink"]
        want = last["row"].clone()
        want[idx.long()] += vals
        got = tfl.pack_stacked(st.params)[0][event["cluster"]]
        assert torch.equal(got, want)
        events.append(event)

    eng = TS.build_engine(scn, hfl, lp=LatencyParams(M=32, model_params=1e6))
    step = masked(thfl.make_masked_cluster_train_step(
        t_loss_fn(tcfg), TSGDM(momentum=0.9), lambda s: 0.05))
    batches = ({"tokens": torch.from_numpy(b).long()}
               for b in _batches(tcfg.vocab_size, 2, 4))
    _, trace = eng.run(state, None, None, batches, 4, masked_train_step=step,
                       on_async_sync=hook)
    syncs = [r for r in trace.rows if r["kind"] == "sync"]
    assert [e["cluster"] for e in events] == [r["cluster"] for r in syncs]
    assert [e["index"] for e in events] == list(range(1, len(syncs) + 1))
    assert all(e["seconds"] >= 0 and e["uplink"][0].numel() > 0 for e in events)
