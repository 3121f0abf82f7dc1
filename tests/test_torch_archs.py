"""All ten architectures: the registry, the reduced configs and param trees,
and the forward, loss and gradients of every reduced config, the port
against the reference on the same weights and tokens (and the same
frontend embeddings), carried across through numpy.

Exact: every config field, the tree layout (keys, shapes, dtypes) and the
hybrid's static segments. f32 model math (``dtype="float32"``): logits,
aux, loss and every gradient leaf at atol and rtol 1e-4 (measured: logits
and loss at most 3e-6, gradients at most 1.7e-5 of a leaf's largest entry).
bf16 (the configs as registered): one forward per architecture, held at
3e-2 of the logits' largest magnitude (measured at most 1.5e-2), as
``tests/test_torch_model.py`` holds olmo's (bf16 products round at other
places in XLA and ATen).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.configs import get_config as j_get
from repro.launch.steps import make_loss_fn as j_loss_fn
from repro.models import transformer as JT
from repro_torch.configs import ARCHS as T_ARCHS
from repro_torch.configs import PORT_ONLY
from repro_torch.configs import get_config as t_get
from repro_torch.configs.base import ModelConfig as TModelConfig
from repro_torch.launch.steps import make_loss_fn as t_loss_fn
from repro_torch.models import transformer as TT
from repro_torch.utils.convert import params_from_numpy
from repro_torch.utils.tree import tree_flatten, tree_leaves

torch.use_deterministic_algorithms(True)
torch.set_num_threads(2)

NAMES = sorted(J_ARCHS)
TOL = dict(rtol=1e-4, atol=1e-4)


def _t(cfg):
    return TModelConfig(**dataclasses.asdict(cfg))


def _f32(name):
    return dataclasses.replace(j_get(name).reduced(), dtype="float32")


def _inputs(cfg, B=2, T=12, seed=1):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    fe = None
    if cfg.frontend != "none":
        fe = (0.02 * rng.standard_normal((B, cfg.frontend_tokens, JT.frontend_dim(cfg)))
              ).astype(np.float32)
    return toks, fe


def _port_inputs(toks, fe):
    return (torch.from_numpy(toks).long(),
            None if fe is None else torch.from_numpy(fe))


def test_registry_knows_all_ten():
    # the reference's ten, and the port's own entries beside them
    assert sorted(set(T_ARCHS) - set(PORT_ONLY)) == NAMES and len(NAMES) == 10
    assert set(PORT_ONLY) <= set(T_ARCHS) and not set(PORT_ONLY) & set(NAMES)
    with pytest.raises(KeyError) as jerr:
        j_get("nope")
    with pytest.raises(KeyError) as terr:
        t_get("nope")
    # the same message, naming the port's registry
    assert str(terr.value) == str(jerr.value).replace(str(NAMES), str(sorted(T_ARCHS)))


@pytest.mark.parametrize("name", NAMES)
def test_configs_match_reference_field_for_field(name):
    for full in (True, False):
        j, t = j_get(name), t_get(name)
        if not full:
            j, t = j.reduced(), t.reduced()
        # the reference's fields alike; the port's own (MoE settings, YaRN)
        # at their defaults, which leave the reference's configs as they are
        tj, jj = dataclasses.asdict(t), dataclasses.asdict(j)
        assert {k: tj[k] for k in jj} == jj
        assert {k: v for k, v in tj.items() if k not in jj} == {
            k: v for k, v in dataclasses.asdict(TModelConfig("x", "dense", 1, 1, 1, 1, 1, 1)).items()
            if k not in jj}
    assert t_get(name).__doc__ == j_get(name).__doc__


@pytest.mark.parametrize("name", NAMES)
def test_param_tree_matches_reference_layout(name):
    cfg = j_get(name).reduced()
    jshapes = jax.eval_shape(lambda k: JT.init_model(k, cfg), jax.random.PRNGKey(0))
    jl = jax.tree_util.tree_flatten_with_path(jshapes)[0]
    tl, tdef = tree_flatten(TT.init_model(None, _t(cfg), device="meta"))
    assert [tuple(k.key for k in path) for path, _ in jl] == list(tdef)
    for (path, a), b in zip(jl, tl):
        assert tuple(a.shape) == tuple(b.shape), path
        assert str(a.dtype) == str(b.dtype).replace("torch.", ""), path


@pytest.mark.parametrize("name", NAMES)
def test_forward_loss_and_grads_match_reference_f32(name):
    cfg = _f32(name)
    jp = JT.init_model(jax.random.PRNGKey(0), cfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    toks, fe = _inputs(cfg)
    jfe = None if fe is None else jnp.asarray(fe)
    jlog, jaux = jax.jit(lambda p, t, f: JT.forward(p, t, cfg, frontend_embeds=f))(
        jp, jnp.asarray(toks), jfe)
    ttoks, tfe = _port_inputs(toks, fe)
    with torch.no_grad():
        tlog, taux = TT.forward(tp, ttoks, _t(cfg), frontend_embeds=tfe)
    V = cfg.vocab_size
    np.testing.assert_allclose(tlog.numpy()[..., :V], np.asarray(jlog)[..., :V], **TOL)
    np.testing.assert_allclose(float(taux), float(jaux), **TOL)
    if cfg.num_experts:
        assert float(taux) > 0

    batch = {"tokens": jnp.asarray(toks)}
    if fe is not None:
        batch["frontend"] = jfe
    (jloss, _), jg = jax.jit(jax.value_and_grad(j_loss_fn(cfg), has_aux=True))(
        jp, batch)
    for leaf in tree_leaves(tp):
        leaf.requires_grad_(True)
    tbatch = {"tokens": ttoks}
    if tfe is not None:
        tbatch["frontend"] = tfe
    tloss, _ = t_loss_fn(_t(cfg))(tp, tbatch)
    tloss.backward()
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), **TOL)
    for a, b in zip(tree_leaves(tp), jax.tree.leaves(jg)):
        b = np.asarray(b)
        got = a.grad.numpy() if a.grad is not None else np.zeros_like(b)  # unused leaf
        np.testing.assert_allclose(got, b, rtol=1e-4,
                                   atol=1e-4 * max(np.abs(b).max(), 1e-12))


@pytest.mark.parametrize("name", NAMES)
def test_forward_matches_reference_bf16(name):
    cfg = j_get(name).reduced()
    jp = JT.init_model(jax.random.PRNGKey(0), cfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    toks, fe = _inputs(cfg, seed=2)
    jlog, _ = jax.jit(lambda p, t, f: JT.forward(p, t, cfg, frontend_embeds=f))(
        jp, jnp.asarray(toks), None if fe is None else jnp.asarray(fe))
    ttoks, tfe = _port_inputs(toks, fe)
    with torch.no_grad():
        tlog, _ = TT.forward(tp, ttoks, _t(cfg), frontend_embeds=tfe)
    V = cfg.vocab_size
    jl = np.asarray(jlog, np.float32)[..., :V]
    assert np.isfinite(tlog.float().numpy()).all()
    np.testing.assert_allclose(tlog.float().numpy()[..., :V], jl, rtol=0,
                               atol=3e-2 * np.abs(jl).max())


@pytest.mark.parametrize("layers,every", [(2, 2), (7, 6), (81, 6), (4, 2), (5, 3)])
def test_hybrid_segments_match_reference(layers, every):
    cfg = dataclasses.replace(j_get("zamba2-7b"), num_layers=layers, attn_every=every)
    assert TT._segments(_t(cfg)) == JT._segments(cfg)
    assert TT.num_shared_attn_sites(_t(cfg)) == JT.num_shared_attn_sites(cfg)
