"""One consensus sync from the same state, the port against the reference.

The state is the reference's ``hfl_init`` output, perturbed with numpy
noise and carried across with ``state_from_numpy``; the reference runs its
jitted, donating sync. Everything the sync writes (per-cluster params,
w_ref, eps, e) must be BITWISE equal: the port repeats the reference's
f32 arithmetic in its order, and the Ω selections are exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.configs.base import HFLConfig as JHFLConfig
from repro.configs.base import ModelConfig
from repro.core import hfl as jhfl
from repro.kernels.fused_sync import ops as jops
from repro.models.transformer import init_model
from repro.optim import SGDM as JSGDM
from repro_torch.configs.base import HFLConfig as THFLConfig
from repro_torch.core import hfl as thfl
from repro_torch.kernels.fused_sync import ops as tops
from repro_torch.optim import SGDM as TSGDM
from repro_torch.utils import flatten as tfl
from repro_torch.utils.convert import params_from_numpy, state_from_numpy
from repro_torch.utils.tree import tree_leaves

torch.use_deterministic_algorithms(True)
torch.set_num_threads(2)

OLMO = get_config("olmo-1b").reduced()
TINY = ModelConfig(name="t", arch_type="dense", num_layers=2, d_model=32,
                   num_heads=4, num_kv_heads=2, d_ff=64, vocab_size=61,
                   norm_type="nonparametric_ln", tie_embeddings=True,
                   dtype="float32", remat=False)


def _tiers(N):
    return ((2, 1, 0.99, 0.9), (N, 2, 0.9, 0.9, 0.5, 0.2))


def _states(cfg, N, seed=0, buffer_dtype=jnp.float32, **kw):
    hfl = JHFLConfig(tiers=_tiers(N), **kw)
    params = init_model(jax.random.PRNGKey(seed), cfg)
    state = jhfl.hfl_init(params, JSGDM(momentum=0.9), hfl, buffer_dtype=buffer_dtype)
    rng = np.random.default_rng(seed)

    def perturb(tree, scale):
        return jax.tree.map(lambda p: jnp.asarray(
            (np.asarray(p, np.float32)
             + scale * rng.standard_normal(p.shape).astype(np.float32)).astype(p.dtype)),
            tree)

    state = state._replace(params=perturb(state.params, 0.1),
                           eps=perturb(state.eps, 0.01), e=perturb(state.e, 0.01))
    np_state = jax.tree.map(np.asarray, state)
    return hfl, state, state_from_numpy(np_state, "cpu")


def _f32(a):
    return np.asarray(a, np.float32) if not torch.is_tensor(a) else a.float().numpy()


def _assert_state_equal(tstate, jstate):
    for field in ("params", "w_ref", "eps", "e"):
        tl = tree_leaves(getattr(tstate, field))
        jl = jax.tree.leaves(getattr(jstate, field))
        assert len(tl) == len(jl)
        for a, b in zip(tl, jl):
            assert str(a.dtype).replace("torch.", "") == str(b.dtype), field
            np.testing.assert_array_equal(_f32(a), _f32(b), err_msg=field)


def _sync_both(hfl, jstate, tstate):
    jsync = jhfl.jit_sync_step(jhfl.make_sync(jhfl.SyncPlan.from_config(hfl)))
    tcfg = THFLConfig(tiers=tuple(
        (t.fanout, t.period, t.phi_up, t.phi_down, t.beta_up, t.beta_down)
        for t in hfl.tiers), sync_mode=hfl.sync_mode, omega_impl=hfl.omega_impl,
        wire_format=hfl.wire_format)
    tsync = thfl.make_sync(thfl.SyncPlan(tcfg))
    return jsync(jstate), tsync(tstate)


CASES = [("sparse", "topk", "bf16"), ("sparse", "hist", "bf16"),
         ("sparse", "pallas", "bf16"), ("sparse", "fused", "bf16"),
         ("quantized_sparse", "fused", "bf16"), ("quantized_sparse", "topk", "q8"),
         ("quantized_sparse", "pallas", "q8"), ("dense", "topk", "bf16")]


@pytest.mark.parametrize("mode,impl,wire", CASES, ids=["-".join(c) for c in CASES])
def test_one_sync_bitwise(mode, impl, wire):
    hfl, jstate, tstate = _states(OLMO, 2, sync_mode=mode, omega_impl=impl,
                                  wire_format=wire)
    jnew, tnew = _sync_both(hfl, jstate, tstate)
    _assert_state_equal(tnew, jnew)
    # every cluster adopted the same model
    for P in tree_leaves(tnew.params):
        assert torch.equal(P[0], P[1])


@pytest.mark.parametrize("impl", ["topk", "fused"])
def test_sync_three_clusters_and_bf16_buffers(impl):
    """N = 3 exercises the Σ sent / N reduction order; bf16 buffers take
    the packed-copy path instead of the in-place flat buffers."""
    hfl, jstate, tstate = _states(TINY, 3, omega_impl=impl)
    jnew, tnew = _sync_both(hfl, jstate, tstate)
    _assert_state_equal(tnew, jnew)
    hfl, jstate, tstate = _states(TINY, 2, seed=1, buffer_dtype=jnp.bfloat16,
                                  omega_impl=impl)
    jnew, tnew = _sync_both(hfl, jstate, tstate)
    _assert_state_equal(tnew, jnew)


def test_sync_updates_flat_buffers_in_place():
    hfl, jstate, tstate = _states(TINY, 2, omega_impl="fused")
    spec = tfl.spec_of(tstate.w_ref)
    flats = (tfl.backing(tstate.w_ref, spec), tfl.backing(tstate.e, spec),
             tfl.backing(tstate.eps, spec, rows=2))
    assert all(f is not None for f in flats)
    _, tnew = _sync_both(hfl, jstate, tstate)
    assert tfl.backing(tnew.w_ref, spec) is flats[0]
    assert tfl.backing(tnew.eps, spec, rows=2) is flats[2]


def test_uplink_payload_indices_match_reference():
    """Ω index sets and values of the fused uplink on the sync's drift."""
    hfl, jstate, tstate = _states(OLMO, 2, omega_impl="fused")
    s, _ = jhfl._pack_drift(jstate, 0.5)
    k = int(round(0.1 * s.shape[1]))
    jv, ji = jops.select_topk_rows(s, k)
    tv, ti = tops.select_topk_rows(torch.from_numpy(np.array(s)), k, interpret=False)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_hfl_init_matches_reference():
    hfl = JHFLConfig(tiers=_tiers(2))
    jp = init_model(jax.random.PRNGKey(0), OLMO)
    js = jhfl.hfl_init(jp, JSGDM(momentum=0.9), hfl)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    ts = thfl.hfl_init(tp, TSGDM(momentum=0.9), THFLConfig(tiers=_tiers(2)))
    _assert_state_equal(ts, js)
    for a, b in zip(tree_leaves(ts.opt["m"]), jax.tree.leaves(js.opt["m"])):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    served = thfl.serving_params(ts)
    for a, b in zip(tree_leaves(served), jax.tree.leaves(jhfl.serving_params(js))):
        np.testing.assert_array_equal(_f32(a), _f32(b))


def test_unported_plans_raise_with_their_roadmap_item():
    """flat_shards > 1 is ported: with topk it raises the reference's
    ValueError (tests/test_fused.py), with fused it builds."""
    cfg = THFLConfig(tiers=_tiers(2), flat_shards=2, omega_impl="topk")
    with pytest.raises(ValueError, match="flat_shards > 1 requires omega_impl='fused'"):
        thfl.make_sync(thfl.SyncPlan(cfg))
    hfl = JHFLConfig(tiers=_tiers(2), flat_shards=2, omega_impl="topk")
    with pytest.raises(ValueError, match="flat_shards > 1 requires omega_impl='fused'"):
        jhfl.make_sync(jhfl.SyncPlan.from_config(hfl))
    cfg = THFLConfig(tiers=_tiers(2), flat_shards=2, omega_impl="fused")
    assert callable(thfl.make_sync(thfl.SyncPlan(cfg)))
