"""The MoE routing, MLA attention and the gelu MLP: the port against the
reference on the same weights and inputs, carried across through numpy.

Exact: ``_capacity`` and the routing tables (the top-K expert ids with the
lower index first among tied probabilities, the stable sort of the slots,
their destinations and the [E, C] token table with its kept and dropped
slots). The tables are held against the reference's own lines of
``_route_group`` (``lax.top_k``, ``jnp.argsort``, ``searchsorted``, the
drop bin), which its function does not return.

f32 model math: outputs, aux losses, caches and gradients at atol and rtol
1e-4 (measured at most 8e-6). The gelu MLP at atol 1e-6: the reference's
``jax.nn.gelu`` is the tanh approximation, which differs from the exact
erf form by up to 4e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.configs.base import ModelConfig
from repro.models import attention as JA
from repro.models import mlp as JMLP
from repro.models import moe as JM
from repro_torch.configs.base import ModelConfig as TModelConfig
from repro_torch.models import attention as TA
from repro_torch.models import mlp as TMLP
from repro_torch.models import moe as TM
from repro_torch.utils.convert import params_from_numpy
from repro_torch.utils.tree import tree_leaves

torch.use_deterministic_algorithms(True)
torch.set_num_threads(2)

TOL = dict(rtol=1e-4, atol=1e-4)


def _t(cfg):
    return TModelConfig(**dataclasses.asdict(cfg))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _moe_cfg(**kw):
    base = dict(name="m", arch_type="moe", num_layers=1, d_model=32, num_heads=4,
                num_kv_heads=2, d_ff=0, vocab_size=64, num_experts=4,
                experts_per_token=2, moe_d_ff=16, capacity_factor=1.25,
                dtype="float32", remat=False)
    base.update(kw)
    return ModelConfig(**base)


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_gelu_mlp_matches_reference():
    cfg = ModelConfig(name="g", arch_type="dense", num_layers=1, d_model=32,
                      num_heads=4, num_kv_heads=4, d_ff=64, vocab_size=64,
                      act="gelu", gated_mlp=False, dtype="float32")
    p = JMLP.init_mlp(jax.random.PRNGKey(0), cfg)
    x = 2.0 * _x((4, 8, 32), 0)
    want = np.asarray(JMLP.mlp_forward(p, jnp.asarray(x), cfg))
    got = TMLP.mlp_forward(params_from_numpy(_np(p), "cpu"), torch.from_numpy(x), _t(cfg))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("E,K,cf", [(4, 2, 1.25), (160, 6, 1.25), (16, 4, 0.25),
                                    (4, 2, 8.0)])
def test_capacity_matches_reference(E, K, cf):
    cfg = _moe_cfg(num_experts=E, experts_per_token=K, capacity_factor=cf)
    for T in (1, 7, 40, 96, 384, 1024):
        assert TM._capacity(_t(cfg), T) == JM._capacity(cfg, T), T


def _ref_tables(x, router, cfg):
    """The routing lines of the reference's ``_route_group``."""
    T = x.shape[0]
    E, K = cfg.num_experts, cfg.experts_per_token
    C = JM._capacity(cfg, T)
    probs = jax.nn.softmax(x.astype(jnp.float32) @ router, axis=-1)
    gate_vals, expert_ids = jax.lax.top_k(probs, K)
    flat_e = expert_ids.reshape(-1)
    order = jnp.argsort(flat_e)
    e_s = flat_e[order]
    t_s = jnp.repeat(jnp.arange(T), K)[order]
    seg_start = jnp.searchsorted(e_s, jnp.arange(E), side="left")
    pos = jnp.arange(T * K) - seg_start[e_s]
    dest = jnp.where(pos < C, e_s * C + pos, E * C)
    idx = jnp.full((E * C + 1,), T, jnp.int32).at[dest].set(t_s.astype(jnp.int32))
    return {"expert_ids": expert_ids, "order": order, "dest": dest,
            "idx": idx[:-1].reshape(E, C)}


ROUTE_CASES = {
    "ample": dict(capacity_factor=8.0),
    "tight": dict(capacity_factor=0.25),
    "zero_router": dict(),  # every probability ties
}


@pytest.mark.parametrize("case", sorted(ROUTE_CASES))
def test_route_group_matches_reference(case):
    cfg = _moe_cfg(**ROUTE_CASES[case])
    p = JM.init_moe(jax.random.PRNGKey(3), cfg)
    if case == "zero_router":
        p["router"] = jnp.zeros_like(p["router"])
    tp = params_from_numpy(_np(p), "cpu")
    x = _x((40, cfg.d_model), 4)
    want = _ref_tables(jnp.asarray(x), p["router"], cfg)
    got = TM.route_tables(torch.from_numpy(x), tp["router"], _t(cfg))
    for k, w in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(w), err_msg=k)
    kept = np.asarray(want["dest"]) < cfg.num_experts * JM._capacity(cfg, 40)
    if case == "ample":
        assert kept.all()
    else:
        assert not kept.all()  # the capacity cut drops slots here
    jy, jaux = JM._route_group(jnp.asarray(x), p, cfg)
    ty, taux = TM._route_group(torch.from_numpy(x), tp, _t(cfg))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(float(taux), float(jaux), **TOL)


def _moe_loss(fwd, p, x, cfg, w):
    y, aux = fwd(p, x, cfg, groups=2)
    return (y * w).sum() + aux


def test_moe_forward_shared_expert_groups_and_gradient():
    """groups = 2 with a shared expert and tight capacity: outputs, aux and
    the gradients of every leaf and of x (jax.grad against autograd)."""
    cfg = _moe_cfg(num_shared_experts=1, capacity_factor=0.5)
    p = JM.init_moe(jax.random.PRNGKey(5), cfg)
    x = _x((2, 12, cfg.d_model), 6)
    w = _x((2, 12, cfg.d_model), 7)
    (jy, jaux) = JM.moe_forward(p, jnp.asarray(x), cfg, groups=2)
    jg, jgx = jax.grad(lambda p, x: _moe_loss(JM.moe_forward, p, x, cfg, jnp.asarray(w)),
                       argnums=(0, 1))(p, jnp.asarray(x))
    tp = params_from_numpy(_np(p), "cpu")
    for t in tree_leaves(tp):
        t.requires_grad_(True)
    tx = torch.from_numpy(x).requires_grad_(True)
    ty, taux = TM.moe_forward(tp, tx, _t(cfg), groups=2)
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(float(taux.detach()), float(jaux), **TOL)
    _moe_loss(TM.moe_forward, tp, tx, _t(cfg), torch.from_numpy(w)).backward()
    assert "shared" in tp
    for a, b in zip(tree_leaves(tp), jax.tree.leaves(jg)):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(b), **TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), **TOL)


MLA = dataclasses.replace(get_config("deepseek-v2-236b").reduced(),
                          dtype="float32")


def test_mla_forward_fill_and_decode_match_reference():
    p = JA.init_mla(jax.random.PRNGKey(8), MLA)
    tp = params_from_numpy(_np(p), "cpu")
    B, T, S = 2, 10, 16
    x = _x((B, T, MLA.d_model), 9)
    np.testing.assert_allclose(
        TA.mla_forward(tp, torch.from_numpy(x), _t(MLA)).numpy(),
        np.asarray(JA.mla_forward(p, jnp.asarray(x), MLA)), **TOL)
    jckv, jkr = JA.mla_fill_cache(p, jnp.asarray(x), MLA)
    tckv, tkr = TA.mla_fill_cache(tp, torch.from_numpy(x), _t(MLA))
    np.testing.assert_allclose(tckv.numpy(), np.asarray(jckv), **TOL)
    np.testing.assert_allclose(tkr.numpy(), np.asarray(jkr), **TOL)

    # decode one token into a cache holding the prompt, the rows at
    # different positions (one of them past an empty slot)
    cache_ckv = np.zeros((B, S, MLA.kv_lora_rank), np.float32)
    cache_kr = np.zeros((B, S, MLA.qk_rope_head_dim), np.float32)
    cache_ckv[:, :T], cache_kr[:, :T] = np.asarray(jckv), np.asarray(jkr)
    slot_pos = np.full((B, S), -1, np.int32)
    slot_pos[:, :T] = np.arange(T)
    pos = np.array([T, T + 1], np.int32)
    slot = pos.copy()
    slot_pos[np.arange(B), slot] = pos
    xt = _x((B, 1, MLA.d_model), 10)
    jo, jc, jk = JA.mla_decode(p, jnp.asarray(xt), jnp.asarray(cache_ckv),
                               jnp.asarray(cache_kr), jnp.asarray(slot_pos),
                               jnp.asarray(slot), jnp.asarray(pos), MLA)
    to, tc, tk = TA.mla_decode(tp, torch.from_numpy(xt), torch.from_numpy(cache_ckv),
                               torch.from_numpy(cache_kr),
                               torch.from_numpy(slot_pos).long(),
                               torch.from_numpy(slot).long(),
                               torch.from_numpy(pos).long(), _t(MLA))
    for a, b in ((to, jo), (tc, jc), (tk, jk)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
