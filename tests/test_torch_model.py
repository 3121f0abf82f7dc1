"""Dense transformer, loss and train step: the port against the reference on
the same weights, carried across through numpy.

Tolerances: bf16 params and matmuls round at other places in the two
frameworks (XLA's CPU dot vs ATen's, jax's bf16 silu vs torch's), so bf16
logits and one-step gradients agree to a few bf16 ulps, not bitwise:
measured at most 1.1e-2 (logits) and 1.4e-2 (momentum) of the array's
largest magnitude, held to 3e-2. The f32 config differs only by f32
summation order: measured 1.7e-6 of the largest magnitude, held to 1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.configs.base import ModelConfig
from repro.core import hfl as jhfl
from repro.launch.steps import make_loss_fn as j_loss_fn
from repro.models.transformer import forward as j_forward
from repro.models.transformer import init_model as j_init
from repro.optim import SGDM as JSGDM
from repro.optim import warmup_step_decay as j_sched
from repro_torch.configs.base import ModelConfig as TModelConfig
from repro_torch.core import hfl as thfl
from repro_torch.launch.steps import make_loss_fn as t_loss_fn
from repro_torch.models.transformer import forward as t_forward
from repro_torch.models.transformer import init_model as t_init
from repro_torch.optim import SGDM as TSGDM
from repro_torch.optim import warmup_step_decay as t_sched
from repro_torch.utils.convert import params_from_numpy, state_from_numpy
from repro_torch.utils.tree import tree_leaves

torch.use_deterministic_algorithms(True)
torch.set_num_threads(2)

OLMO = get_config("olmo-1b").reduced()
# GQA (2 kv heads), a padded vocab (600 -> 1024) and f32 math
GQA32 = ModelConfig(name="t", arch_type="dense", num_layers=2, d_model=64,
                    num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=600,
                    norm_type="nonparametric_ln", tie_embeddings=True,
                    dtype="float32", remat=False)
# cfg -> (logits atol as a fraction of the logit scale, loss rtol)
TOL = {"bf16": (3e-2, 5e-3), "f32": (1e-5, 1e-6)}


def _t_cfg(cfg):
    return TModelConfig(**dataclasses.asdict(cfg))


def _kind(cfg):
    return "f32" if cfg.dtype == "float32" else "bf16"


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape).astype(np.int32)


@pytest.mark.parametrize("cfg", [OLMO, GQA32], ids=["olmo-reduced-bf16", "gqa-f32"])
def test_forward_logits_match_reference(cfg):
    jp = j_init(jax.random.PRNGKey(0), cfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    toks = _tokens(cfg, (2, 24), 1)
    jl, _ = j_forward(jp, jnp.asarray(toks), cfg)
    with torch.no_grad():
        tl, _ = t_forward(tp, torch.from_numpy(toks).long(), _t_cfg(cfg))
    jl = np.asarray(jl, np.float32)
    tl = tl.float().numpy()
    assert tl.shape == jl.shape
    V = cfg.vocab_size
    np.testing.assert_array_equal(tl[..., V:], jl[..., V:])  # masked padding
    scale = np.abs(jl[..., :V]).max()
    np.testing.assert_allclose(tl[..., :V], jl[..., :V], rtol=0,
                               atol=TOL[_kind(cfg)][0] * scale)


def test_init_model_layout_matches_reference():
    jp = j_init(jax.random.PRNGKey(0), OLMO)
    tp = t_init(torch.Generator().manual_seed(0), _t_cfg(OLMO), device="cpu")
    jl, jdef = jax.tree_util.tree_flatten_with_path(jp)
    for (path, a), b in zip(jl, tree_leaves(tp)):
        assert tuple(a.shape) == tuple(b.shape), path
        assert str(a.dtype) == str(b.dtype).replace("torch.", ""), path
    assert len(jl) == len(tree_leaves(tp))


@pytest.mark.parametrize("cfg", [OLMO, GQA32], ids=["olmo-reduced-bf16", "gqa-f32"])
def test_one_train_step_matches_reference(cfg):
    from repro.configs.base import HFLConfig

    hfl = HFLConfig(tiers=((2, 1, 0.99, 0.9), (2, 2, 0.9, 0.9, 0.5, 0.2)))
    jp = j_init(jax.random.PRNGKey(0), cfg)
    jstate = jhfl.hfl_init(jp, JSGDM(momentum=0.9, weight_decay=1e-4), hfl)
    tstate = state_from_numpy(jax.tree.map(np.asarray, jstate), "cpu")
    toks = _tokens(cfg, (2, 4, 16), 2)
    jstep = jax.jit(jhfl.make_cluster_train_step(
        j_loss_fn(cfg), JSGDM(momentum=0.9, weight_decay=1e-4), j_sched(0.05, 1)))
    jnew, jloss = jstep(jstate, {"tokens": jnp.asarray(toks)})
    tstep = thfl.make_cluster_train_step(
        t_loss_fn(_t_cfg(cfg)), TSGDM(momentum=0.9, weight_decay=1e-4), t_sched(0.05, 1))
    tnew, tloss = tstep(tstate, {"tokens": torch.from_numpy(toks).long()})
    atol, rtol = TOL[_kind(cfg)]
    np.testing.assert_allclose(tloss.numpy(), np.asarray(jloss), rtol=rtol)
    assert tnew.step == 1
    # momentum after one step = grad (+ decay): compare at the grad scale
    for a, b in zip(tree_leaves(tnew.opt["m"]), jax.tree.leaves(jnew.opt["m"])):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=atol * max(np.abs(b).max(), 1e-12))
    for a, b in zip(tree_leaves(tnew.params), jax.tree.leaves(jnew.params)):
        b = np.asarray(b, np.float32)
        np.testing.assert_allclose(a.float().numpy(), b, rtol=0,
                                   atol=atol * max(np.abs(b).max(), 1e-12))


@pytest.mark.parametrize("opt_name", ["sgdm-nesterov", "adamw"])
def test_optimizer_update_matches_reference(opt_name):
    """Two updates on f32 leaves (a 2-D leaf is decayed, a 1-D one not):
    f32 arithmetic, up to XLA's fma contraction (held to 1e-6 relative)."""
    from repro.optim import AdamW as JAdamW
    from repro_torch.optim import AdamW as TAdamW

    if opt_name == "adamw":
        jopt, topt = JAdamW(weight_decay=0.1), TAdamW(weight_decay=0.1)
    else:
        jopt = JSGDM(momentum=0.9, weight_decay=1e-2, nesterov=True)
        topt = TSGDM(momentum=0.9, weight_decay=1e-2, nesterov=True)
    rng = np.random.default_rng(3)
    p = {"w": rng.standard_normal((8, 5)).astype(np.float32),
         "b": rng.standard_normal(5).astype(np.float32)}
    jp = jax.tree.map(jnp.asarray, p)
    tp = params_from_numpy(p, "cpu")
    js, ts = jopt.init(jp), topt.init(tp)
    for i in range(2):
        g = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in p.items()}
        jp, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp, 0.05)
        tp, ts = topt.update(params_from_numpy(g, "cpu"), ts, tp, 0.05)
    for k in p:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-7)


def test_schedules_match_reference():
    from repro.optim import constant_lr as j_const
    from repro_torch.optim import constant_lr as t_const

    js, ts = j_sched(0.1, 4, decay_steps=(6, 9)), t_sched(0.1, 4, decay_steps=(6, 9))
    for step in range(12):
        assert ts(step) == float(js(step)), step
    assert t_const(0.3)(5) == float(j_const(0.3)(5))


def test_row_weighted_loss_matches_reference():
    jp = j_init(jax.random.PRNGKey(1), GQA32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    toks = _tokens(GQA32, (3, 12), 4)
    w = np.array([1.0, 0.5, 0.25], np.float32)
    jl, _ = j_loss_fn(GQA32)(jp, {"tokens": jnp.asarray(toks), "row_weight": jnp.asarray(w)})
    with torch.no_grad():
        tl, _ = t_loss_fn(_t_cfg(GQA32))(tp, {"tokens": torch.from_numpy(toks).long(),
                                              "row_weight": torch.from_numpy(w)})
    np.testing.assert_allclose(float(tl), float(jl), rtol=TOL["f32"][1])
