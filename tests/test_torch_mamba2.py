"""The Mamba2 SSD and block: the port against the reference on the same
inputs and weights, carried across through numpy.

All SSD math is f32 on both sides; outputs, states and conv tails at atol
and rtol 1e-4 (measured at most 1.3e-5). The chunked scan is also held
against the port's own step-by-step oracle at the reference's
``tests/test_models.py`` tolerance, 2e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import mamba2 as JM
from repro_torch.configs.base import ModelConfig as TModelConfig
from repro_torch.models import mamba2 as TM
from repro_torch.utils.convert import params_from_numpy

torch.use_deterministic_algorithms(True)
torch.set_num_threads(2)

TOL = dict(rtol=1e-4, atol=1e-4)
CFG = dataclasses.replace(get_config("mamba2-780m").reduced(), dtype="float32")


def _ssd_inputs(B, T, H, P, G, N, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    x, Bm, Cm = f(B, T, H, P), f(B, T, G, N), f(B, T, G, N)
    dt = np.log1p(np.exp(f(B, T, H))).astype(np.float32)  # softplus > 0
    A = -np.exp(f(H))
    D = f(H)
    return x, dt, A, Bm, Cm, D


def _both(fn_j, fn_t, args):
    want = fn_j(*[jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args])
    got = fn_t(*[torch.from_numpy(a) if isinstance(a, np.ndarray) else a for a in args])
    return got, want


def _close(got, want, **tol):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), **(tol or TOL))


@pytest.mark.parametrize("T,chunk,G", [(13, 4, 1), (13, 4, 2), (16, 8, 2),
                                       (5, 8, 1), (37, 16, 1)],
                         ids=["pad-3-chunks", "pad-G2", "exact-G2", "T<chunk",
                              "pad-3-chunks-16"])
def test_ssd_chunked_matches_reference(T, chunk, G):
    args = _ssd_inputs(2, T, 4, 8, G, 6, seed=T + G)
    got, want = _both(lambda *a: JM.ssd_chunked(*a, chunk),
                      lambda *a: TM.ssd_chunked(*a, chunk), args)
    _close(got, want)
    # the port's chunked scan against its own oracle
    _close(got, TM.ssd_sequential(*[torch.from_numpy(a) for a in args]),
           rtol=2e-4, atol=2e-4)


def test_ssd_sequential_and_step_match_reference():
    args = _ssd_inputs(2, 9, 4, 8, 2, 6, seed=1)
    got, want = _both(JM.ssd_sequential, TM.ssd_sequential, args)
    _close(got, want)
    x, dt, A, Bm, Cm, D = args
    h = np.random.default_rng(2).standard_normal((2, 4, 8, 6)).astype(np.float32)
    got, want = _both(JM.ssd_step, TM.ssd_step,
                      (h, x[:, 0], dt[:, 0], A, Bm[:, 0], Cm[:, 0], D))
    _close(got, want)


def _block():
    p = JM.init_mamba2(jax.random.PRNGKey(0), CFG)
    # non-trivial conv bias, dt bias and skip, so every term shows
    rng = np.random.default_rng(3)
    p = jax.tree.map(np.asarray, p)
    for k in ("conv_b", "dt_bias", "D"):
        p[k] = (0.1 * rng.standard_normal(p[k].shape)).astype(np.float32)
    return p, params_from_numpy(p, "cpu")


@pytest.mark.parametrize("T", [2, 3, 40], ids=["T<W-1", "T=W-1", "T>chunk"])
def test_mamba2_forward_with_state_matches_reference(T):
    p, tp = _block()
    x = np.random.default_rng(T).standard_normal((2, T, CFG.d_model)).astype(np.float32)
    want = JM.mamba2_forward(jax.tree.map(jnp.asarray, p), jnp.asarray(x), CFG,
                             return_state=True)
    got = TM.mamba2_forward(tp, torch.from_numpy(x), TModelConfig(
        **dataclasses.asdict(CFG)), return_state=True)
    assert got[2].shape == (2, CFG.ssm_conv_width - 1, TM.mamba2_dims(CFG)[4])
    _close(got, want)


def test_mamba2_decode_matches_reference():
    p, tp = _block()
    rng = np.random.default_rng(5)
    _, H, _, N, d_conv = TM.mamba2_dims(CFG)
    x = rng.standard_normal((2, 1, CFG.d_model)).astype(np.float32)
    buf = rng.standard_normal((2, CFG.ssm_conv_width - 1, d_conv)).astype(np.float32)
    state = rng.standard_normal((2, H, CFG.ssm_headdim, N)).astype(np.float32)
    want = JM.mamba2_decode(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                            jnp.asarray(buf), jnp.asarray(state), CFG)
    got = TM.mamba2_decode(tp, torch.from_numpy(x), torch.from_numpy(buf),
                           torch.from_numpy(state),
                           TModelConfig(**dataclasses.asdict(CFG)))
    _close(got, want)


def test_init_mamba2_matches_reference_constants():
    """A_log = log(linspace(1, 16, H)) and the f32 leaves, stacked per
    layer; A_log to an ulp (XLA's f32 log and ATen's round apart)."""
    jp = JM.init_mamba2(jax.random.PRNGKey(0), CFG)
    tp = TM.init_mamba2(torch.Generator().manual_seed(0),
                        TModelConfig(**dataclasses.asdict(CFG)), lead=(3,),
                        device="cpu")
    for k in ("A_log", "D", "dt_bias", "norm_scale", "conv_b"):
        for layer in range(3):
            np.testing.assert_allclose(tp[k][layer].numpy(), np.asarray(jp[k]),
                                       rtol=2e-7, atol=0)
    for k, v in jp.items():
        assert tuple(tp[k].shape) == (3,) + tuple(v.shape), k
        assert str(tp[k].dtype) == "torch." + str(v.dtype), k
