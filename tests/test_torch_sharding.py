"""The sharding policy, the padded flat layout and the sharded flat sync in
one process, the port against the reference (``repro.launch.sharding``,
``repro.utils.flatten``, ``repro.kernels.fused_sync.ops``,
``repro.core.hfl`` with ``flat_shards > 1``).

Tolerances: none for the specs, the layouts, the per-shard candidates,
the merge and the sync state (``assert_array_equal``); the train CLI's
losses at rtol 1e-4, the bf16 model math's tolerance (test_torch_slice).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.configs.base import HFLConfig as JHFLConfig
from repro.configs.base import ModelConfig as JModelConfig
from repro.core import hfl as jhfl
from repro.core.sparsify import keep_count
from repro.kernels.fused_sync import ops as jops
from repro.launch import sharding as jsh
from repro.models import transformer as JT
from repro.optim import SGDM as JSGDM
from repro.utils import flatten as jfl
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs.base import HFLConfig as THFLConfig
from repro_torch.configs.base import ModelConfig as TModelConfig
from repro_torch.core import hfl as thfl
from repro_torch.kernels.fused_sync import ops as tops
from repro_torch.launch import sharding as tsh
from repro_torch.models import transformer as TT
from repro_torch.optim import SGDM as TSGDM
from repro_torch.utils import flatten as tfl
from repro_torch.utils.convert import params_from_numpy, state_from_numpy
from repro_torch.utils.tree import tree_leaves

torch.use_deterministic_algorithms(True)
torch.set_num_threads(2)

FIELDS = ("params", "w_ref", "eps", "e")

# ---------------------------------------------------------------------------
# specs
# ---------------------------------------------------------------------------

NARROW = JModelConfig(name="t", arch_type="dense", num_layers=2, d_model=32,
                      num_heads=4, num_kv_heads=2, d_ff=64, vocab_size=61,
                      dtype="float32", remat=False)
TREES = ["narrow", "deepseek-v2-236b", "mamba2-780m", "zamba2-7b", "olmo-1b"]


def _configs(name):
    if name == "narrow":
        return NARROW, TModelConfig(**dataclasses.asdict(NARROW))
    return get_config(name).reduced(), t_get_config(name).reduced()


@pytest.mark.parametrize("name", TREES)
def test_param_and_cache_specs_equal_reference(name):
    jcfg, tcfg = _configs(name)
    jshapes = jax.eval_shape(lambda k: JT.init_model(k, jcfg), jax.random.PRNGKey(0))
    tparams = TT.init_model(None, tcfg, device="meta")
    jcache = jax.eval_shape(lambda: JT.init_cache(jcfg, 4, 16))
    tcache = TT.init_cache(tcfg, 4, 16, device="meta")
    is_p = lambda s: isinstance(s, jax.sharding.PartitionSpec)
    for data in (1, 2, 4):
        for model in (1, 2, 4):
            want = jax.tree.leaves(jsh.param_specs(jshapes, data=data, model=model),
                                   is_leaf=is_p)
            got = tree_leaves(tsh.param_specs(tparams, data=data, model=model))
            assert [tuple(s) for s in got] == [tuple(s) for s in want]
            led = tree_leaves(tsh.with_leading(
                tsh.param_specs(tparams, data=data, model=model), "pod"))
            assert [tuple(s) for s in led] == [("pod",) + tuple(s) for s in want]
            want = jax.tree.leaves(jsh.cache_specs(jcache, data=data, model=model),
                                   is_leaf=is_p)
            got = tree_leaves(tsh.cache_specs(tcache, data=data, model=model))
            assert [tuple(s) for s in got] == [tuple(s) for s in want]


def test_leaf_and_batch_specs_equal_reference():
    shapes = [(4096, 8192), (100, 8192), (8,), (16, 1), (2, 48, 64), (3, 5, 7)]
    for shape in shapes:
        for data, model in ((16, 16), (2, 4), (4, 1), (1, 2)):
            for kw in ({}, {"skip_axes": (0,)}, {"data_dims": (0,)}):
                assert tuple(tsh.leaf_spec(shape, data=data, model=model, **kw)) == \
                    tuple(jsh.leaf_spec(shape, data=data, model=model, **kw))
    for ndim in (2, 3, 5):
        for pod in (False, True):
            assert tuple(tsh.batch_spec(ndim, pod=pod)) == \
                tuple(jsh.batch_spec(ndim, pod=pod))


def test_rank_block_and_place_block_round_trip():
    x = torch.arange(2 * 8 * 12, dtype=torch.float32).reshape(2, 8, 12)
    spec = tsh.P("pod", ("data", "model"), None)
    shape = {"pod": 2, "data": 2, "model": 2}
    out = torch.zeros_like(x)
    for p in range(2):
        for d in range(2):
            for m in range(2):
                coord = {"pod": p, "data": d, "model": m}
                b = tsh.rank_block(x, spec, shape, coord)
                assert b.shape == (1, 2, 12)
                assert torch.equal(b[0, 0], x[p, 2 * (2 * d + m)])
                tsh.place_block(out, b, spec, shape, coord)
    assert torch.equal(out, x)


# ---------------------------------------------------------------------------
# the padded flat layout
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shards", [2, 3, 4])
def test_padded_flatspec_equals_reference(shards):
    rng = np.random.default_rng(shards)
    tree = {"a": rng.standard_normal(10).astype(np.float32),
            "b": {"c": rng.standard_normal((3, 5)).astype(np.float32),
                  "d": rng.standard_normal(2).astype(np.float32)}}
    jvec, jspec = jfl.pack(jax.tree.map(jnp.asarray, tree), shards=shards)
    ttree = params_from_numpy(tree, "cpu")
    tvec, tspec = tfl.pack(ttree, shards=shards)
    for f in ("total", "shards", "pad", "padded_total", "local_size", "offsets"):
        assert getattr(tspec, f) == getattr(jspec, f), f
    assert all(tspec.shard_slice(s) == jspec.shard_slice(s) for s in range(shards))
    np.testing.assert_array_equal(tvec.numpy(), np.asarray(jvec))
    for a, b in zip(tree_leaves(tfl.unpack(tvec, tspec)), tree_leaves(ttree)):
        assert torch.equal(a, b)
    stacked = {k: v for k, v in tree.items() if k == "a"}
    stacked = {"a": np.stack([stacked["a"], -stacked["a"]])}
    jmat, _ = jfl.pack_stacked(jax.tree.map(jnp.asarray, stacked), shards=shards)
    tmat, sspec = tfl.pack_stacked(params_from_numpy(stacked, "cpu"), shards=shards)
    np.testing.assert_array_equal(tmat.numpy(), np.asarray(jmat))
    assert torch.equal(tfl.unpack_stacked(tmat, sspec)["a"], torch.from_numpy(stacked["a"]))
    # flat-backed buffers take the padded length and are found again
    flat, t = tfl.flat_backed_zeros(tspec, 3, torch.float32, "cpu")
    assert flat.shape == (3, tspec.padded_total)
    assert tfl.backing(t, tspec, rows=3) is flat
    if tspec.pad:
        assert tfl.backing(t, tspec._replace(shards=1, pad=0), rows=3) is None


# ---------------------------------------------------------------------------
# the per-shard stage and the merge
# ---------------------------------------------------------------------------


def _rows(case):
    rng = np.random.default_rng(11)
    n = 4 * 70000
    if case == "gaussian":
        return rng.standard_normal((2, n)).astype(np.float32)
    if case == "heavy-tailed":  # the threshold collapses: shards overflow
        return (rng.standard_normal((2, n)) ** 3
                * np.exp(np.linspace(0, 8, n))).astype(np.float32)
    if case == "zero":
        return np.zeros((1, n), np.float32)
    if case == "ties":
        return np.round(2 * rng.standard_normal((2, n))).astype(np.float32)
    # each shard's first tile holds all its candidates, fewer than the
    # shard's capacity but more than the tile's slots: block_select's
    # second launch
    x = rng.standard_normal((2, n)).astype(np.float32)
    for sh in range(4):
        x[:, sh * n // 4:sh * n // 4 + 12000] = 30.0
    return x


@pytest.mark.parametrize("case", ["gaussian", "heavy-tailed", "zero", "ties",
                                  "skewed tiles"])
def test_shard_stage_and_merge_equal_reference(case):
    x = _rows(case)
    S, L = 4, x.shape[1] // 4
    k = int(0.1 * x.shape[1])
    jparts, tparts = [], []
    second0 = tops.shard_select_candidates.second_launches
    for sh in range(S):
        piece = x[:, sh * L:(sh + 1) * L]
        jv, ji, jm, jth = jops.shard_select_candidates(jnp.asarray(piece), k, S)
        plain = tops.shard_select_candidates(torch.from_numpy(piece), k, S)
        # the CUDA branch's logic (block_select, its second launch) on CPU
        blocks = tops.shard_select_candidates(torch.from_numpy(piece), k, S,
                                              interpret=False)
        for a, b, c in zip((jv, ji, jm, jth), plain, blocks):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
            assert torch.equal(b, c)
        jparts.append((jv, jnp.where(ji < L, ji + sh * L, x.shape[1]), jm, jth))
        tparts.append(plain)
    if case == "skewed tiles":
        assert tops.shard_select_candidates.second_launches > second0
    cat = lambda ps, i: jnp.concatenate([p[i] for p in ps], axis=1)
    jv, ji, jex = jops.merge_shard_candidates(cat(jparts, 0), cat(jparts, 1),
                                              jnp.stack([p[2] for p in jparts], 1),
                                              jnp.stack([p[3] for p in jparts], 1), k)
    tv, ti, tex = thfl._sharded_select(torch.from_numpy(x), k, tfl.FlatSpec(
        None, (), (), (), (), x.shape[1], S, 0))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tex.numpy(), np.asarray(jex))
    if case == "heavy-tailed":
        assert not tex.any()


# ---------------------------------------------------------------------------
# the single-process sharded sync
# ---------------------------------------------------------------------------


def _narrow_state(N=3, certificate_fails=False):
    """tests/test_sharding.py's narrow transformer and state (3 clusters)."""
    hfl = JHFLConfig(num_clusters=N, mus_per_cluster=1, period=1, sync_mode="sparse",
                     phi_sbs_ul=0.9, phi_mbs_dl=0.9, omega_impl="fused")
    params = JT.init_model(jax.random.PRNGKey(0), NARROW)
    state = jhfl.hfl_init(params, JSGDM(), hfl)
    state = state._replace(
        params=jax.tree.map(lambda p: p + 0.1 * jax.random.normal(
            jax.random.PRNGKey(p.ndim + 1), p.shape), state.params),
        eps=jax.tree.map(lambda p: 0.01 * jax.random.normal(
            jax.random.PRNGKey(p.ndim + 2), p.shape), state.eps),
        e=jax.tree.map(lambda p: 0.01 * jax.random.normal(
            jax.random.PRNGKey(p.ndim + 3), p.shape), state.e))
    if certificate_fails:  # one huge entry per leaf: the thresholds collapse
        state = state._replace(params=jax.tree.map(
            lambda p: p.reshape(p.shape[0], -1).at[:, 0].add(1e4).reshape(p.shape),
            state.params))
    return hfl, state


def _port_cfg(hfl, **kw):
    return THFLConfig(tiers=tuple((t.fanout, t.period, t.phi_up, t.phi_down,
                                   t.beta_up, t.beta_down) for t in hfl.tiers),
                      sync_mode=hfl.sync_mode, omega_impl="fused",
                      wire_format=hfl.wire_format, **kw)


def _assert_equal(tstate, jstate):
    for f in FIELDS:
        for a, b in zip(tree_leaves(getattr(tstate, f)),
                        jax.tree.leaves(getattr(jstate, f))):
            assert str(a.dtype).replace("torch.", "") == str(b.dtype), f
            np.testing.assert_array_equal(a.float().numpy(), np.asarray(b, np.float32),
                                          err_msg=f)


WIRES = [("sparse", "bf16"), ("quantized_sparse", "bf16"), ("quantized_sparse", "q8")]


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("mode,wire", WIRES, ids=["none", "bf16", "q8"])
def test_sharded_sync_bitwise(shards, mode, wire):
    hfl, jstate = _narrow_state()
    hfl = dataclasses.replace(hfl, flat_shards=shards, sync_mode=mode, wire_format=wire)
    tstate = state_from_numpy(jax.tree.map(np.asarray, jstate), "cpu")
    jnew = jhfl.jit_sync_step(jhfl.make_sync(jhfl.SyncPlan.from_config(hfl)))(jstate)
    sync = thfl.make_sync(thfl.SyncPlan(_port_cfg(hfl, flat_shards=shards)))
    tnew = sync(tstate)
    _assert_equal(tnew, jnew)
    assert sync.certificates == {"ul": [True] * 3, "dl": True}
    for P in tree_leaves(tnew.params):
        assert all(torch.equal(P[0], P[n]) for n in range(1, 3))


@pytest.mark.parametrize("shards", [2, 4])
def test_sharded_sync_bitwise_when_the_certificate_fails(shards):
    hfl, jstate = _narrow_state(certificate_fails=True)
    hfl = dataclasses.replace(hfl, flat_shards=shards)
    tstate = state_from_numpy(jax.tree.map(np.asarray, jstate), "cpu")
    spec = tfl.spec_of(tstate.w_ref, shards=shards)
    s, _ = jhfl._pack_drift(jstate, hfl.tiers[1].beta_up, shards=shards)
    k = keep_count(spec.total, hfl.tiers[1].phi_up)
    _, _, jexact = jhfl._sharded_select(s, k, shards, spec.local_size,
                                        spec.padded_total)
    assert not np.asarray(jexact).all()  # the reference's certificate fails too
    jnew = jhfl.jit_sync_step(jhfl.make_sync(jhfl.SyncPlan.from_config(hfl)))(jstate)
    sync = thfl.make_sync(thfl.SyncPlan(_port_cfg(hfl, flat_shards=shards)))
    tnew = sync(tstate)
    _assert_equal(tnew, jnew)
    assert sync.certificates["ul"] == np.asarray(jexact).tolist()


def test_sharded_sync_in_place_from_hfl_init():
    """hfl_init pads the flat-backed buffers when flat_shards > 1 (3 here,
    so the narrow model's Q needs a pad), so the sharded sync updates them
    in place; a whole-vector FlatShard of the same state gives the same
    result."""
    hfl, _ = _narrow_state()
    cfg = _port_cfg(hfl, flat_shards=3)
    tcfg = TModelConfig(**dataclasses.asdict(NARROW))
    params = TT.init_model(torch.Generator().manual_seed(0), tcfg, device="cpu")
    state = thfl.hfl_init(params, TSGDM(), cfg)
    g = torch.Generator().manual_seed(1)
    for P in tree_leaves(state.params):
        P.add_(0.1 * torch.randn(P.shape, generator=g))
    spec = tfl.spec_of(state.w_ref, shards=3)
    bufs = (tfl.backing(state.w_ref, spec), tfl.backing(state.e, spec),
            tfl.backing(state.eps, spec, rows=3))
    assert all(b is not None for b in bufs) and spec.pad > 0
    piece = thfl.rank_state(state, thfl.SyncPlan(cfg), {"data": 3, "model": 1},
                            {"data": 1, "model": 0})  # shard 1 of 3
    assert piece.shard == 1 and piece.params.shape == (3, spec.local_size)
    fs = thfl.FlatShard(
        params=tfl.pack_stacked(state.params, shards=3)[0],
        w_ref=bufs[0].clone(), eps=bufs[2].clone(), e=bufs[1].clone(),
        spec=tfl.spec_of_stacked(state.params, shards=3))
    sync = thfl.make_sync(thfl.SyncPlan(cfg))
    new = sync(state)
    assert tfl.backing(new.w_ref, spec) is bufs[0]
    assert tfl.backing(new.eps, spec, rows=3) is bufs[2]
    fs = sync(fs)
    assert torch.equal(fs.w_ref, bufs[0]) and torch.equal(fs.eps, bufs[2])
    assert torch.equal(fs.e, bufs[1])
    assert torch.equal(fs.params, tfl.pack_stacked(new.params, shards=3)[0])


def test_train_cli_flat_shards_matches_reference(monkeypatch):
    """``--flat-shards 2 --omega-impl fused`` through both CLIs from the
    same init: per-step losses and the eval loss at rtol 1e-4, the rows
    identical after each sync."""
    from repro.launch import train as JTR
    from repro_torch.launch import train as TTR

    def port_init(gen, cfg, device=None):
        return params_from_numpy(jax.tree.map(np.asarray, JT.init_model(
            jax.random.PRNGKey(0), get_config("olmo-1b").reduced())), device)

    monkeypatch.setattr(TTR, "init_model", port_init)
    argv = ["--tiers", "2x2:H=2", "--steps", "4", "--batch-per-mu", "2", "--seq", "16",
            "--omega-impl", "fused", "--flat-shards", "2", "--log-every", "4"]
    jhist, jeval = JTR.main(argv)
    identical = []
    out = TTR.run(TTR.parse_args(argv + ["--device", "cpu"]), on_sync=lambda i, st, s:
                  identical.append(all(torch.equal(P[0], P[n])
                                       for P in tree_leaves(st.params)
                                       for n in range(1, P.shape[0]))))
    assert identical == [True, True]
    np.testing.assert_allclose(out["hist"], jhist, rtol=1e-4)
    np.testing.assert_allclose(out["eval_loss"], jeval, rtol=1e-4)
