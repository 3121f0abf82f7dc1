"""The decode/prefill cache of every architecture: the port against the
reference on the same weights, prompts and frontend embeddings, and the
port against itself (decode == forward).

Against the reference, per reduced config in f32 model math: prefill of a
12-token prompt, then 3 greedy decode steps, once with the cache sized to
the prompt (``max_len=None``: every new token lands in the last slot, or a
sliding-window model's oldest, as the reference writes it) and once with
``max_len`` = prompt + frontend + 3. Exact: ``pos``, ``slot_pos`` and the
greedy tokens; logits and every cache tensor at atol and rtol 1e-4
(measured at most 7e-6). Also exact: the slots dropped when ``max_len``
is below the prompt plus the frontend tokens, and the sliding-window ring
once the prompt outgrows its window.

The port against itself, at ``tests/test_models.py``'s settings and
tolerance (2e-3): decode after a prefill sized for the continuation equals
the full-sequence forward for the dense, sliding-window, MLA, MoE (ample
capacity, ``capacity_factor=8``), SSM and hybrid families.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.configs import get_config as j_get
from repro.models import transformer as JT
from repro_torch.configs.base import ModelConfig as TModelConfig
from repro_torch.models import transformer as TT
from repro_torch.utils.convert import params_from_numpy

torch.use_deterministic_algorithms(True)
torch.set_num_threads(2)

TOL = dict(rtol=1e-4, atol=1e-4)
EXACT = ("pos", "slot_pos")


def _t(cfg):
    return TModelConfig(**dataclasses.asdict(cfg))


def _setup(cfg, T, seed=1, B=2):
    jp = JT.init_model(jax.random.PRNGKey(0), cfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    fe = None
    if cfg.frontend != "none":
        fe = (0.02 * rng.standard_normal((B, cfg.frontend_tokens, JT.frontend_dim(cfg)))
              ).astype(np.float32)
    return jp, tp, toks, fe


def _check_cache(tc, jc):
    assert set(tc) == set(jc)
    for k, v in jc.items():
        if k in EXACT:
            np.testing.assert_array_equal(tc[k].numpy(), np.asarray(v), err_msg=k)
        else:
            np.testing.assert_allclose(tc[k].float().numpy(), np.asarray(v, np.float32),
                                       err_msg=k, **TOL)


def _prefill_then_decode(cfg, T, max_len, steps=3, seed=1):
    """Prefill and ``steps`` greedy decode steps on both sides; checks every
    step's logits, tokens and cache. -> the reference's final cache."""
    jp, tp, toks, fe = _setup(cfg, T, seed)
    tcfg = _t(cfg)
    V = cfg.vocab_size
    jpre = jax.jit(lambda p, t, f: JT.prefill(p, t, cfg, frontend_embeds=f,
                                              max_len=max_len))
    jdec = jax.jit(lambda p, c, t: JT.decode_step(p, c, t, cfg))
    jl, jc = jpre(jp, jnp.asarray(toks), None if fe is None else jnp.asarray(fe))
    with torch.no_grad():
        tl, tc = TT.prefill(tp, torch.from_numpy(toks).long(), tcfg,
                            frontend_embeds=None if fe is None else torch.from_numpy(fe),
                            max_len=max_len)
    np.testing.assert_allclose(tl.numpy()[..., :V], np.asarray(jl)[..., :V], **TOL)
    _check_cache(tc, jc)
    jtok = np.asarray(jnp.argmax(jl[:, -1:], -1))
    ttok = tl[:, -1:].argmax(-1)
    for _ in range(steps):
        np.testing.assert_array_equal(ttok.numpy(), jtok)
        jl, jc = jdec(jp, jc, jnp.asarray(jtok, jnp.int32))
        with torch.no_grad():
            tl, tc = TT.decode_step(tp, tc, ttok, tcfg)
        np.testing.assert_allclose(tl.numpy()[..., :V], np.asarray(jl)[..., :V], **TOL)
        _check_cache(tc, jc)
        jtok = np.asarray(jnp.argmax(jl, -1))
        ttok = tl.argmax(-1)
    np.testing.assert_array_equal(ttok.numpy(), jtok)
    return jc


def _f32(name):
    return dataclasses.replace(j_get(name).reduced(), dtype="float32")


@pytest.mark.parametrize("sized", [False, True], ids=["prompt-sized", "max_len"])
@pytest.mark.parametrize("name", sorted(J_ARCHS))
def test_prefill_and_decode_match_reference(name, sized):
    cfg = _f32(name)
    F = cfg.frontend_tokens if cfg.frontend != "none" else 0
    _prefill_then_decode(cfg, 12, (12 + F + 3) if sized else None)


def test_out_of_range_prompt_slots_are_dropped():
    """llava at ``tests/test_arch_smoke.py``'s sizes: 12 text tokens after
    16 frames into a cache of 16 slots keeps positions 12..15 only."""
    jc = _prefill_then_decode(_f32("llava-next-34b"), 12, 16, steps=1)
    # the decode step wrote position 28 into the last slot
    want = np.array([[-1] * 12 + [12, 13, 14, 28]] * 2)
    np.testing.assert_array_equal(np.asarray(jc["slot_pos"]), want)


@pytest.mark.parametrize("max_len", [None, 90], ids=["prompt-sized", "max_len"])
def test_sliding_window_ring_wraps(max_len):
    """danube (window 64) with an 80-token prompt: the cache holds the last
    64 positions at ``pos % 64``, and decode overwrites the oldest."""
    jc = _prefill_then_decode(_f32("h2o-danube-3-4b"), 80, max_len)
    sp = np.asarray(jc["slot_pos"])[0]
    assert sp.shape == (64,) and sorted(sp) == list(range(19, 83))
    assert all(sp[p % 64] == p for p in range(19, 83))


_FAMILIES = {
    "dense": dict(arch_type="dense"),
    "swa": dict(arch_type="dense", sliding_window=8),
    "mla": dict(arch_type="dense", use_mla=True, kv_lora_rank=32, q_lora_rank=32,
                qk_rope_head_dim=8, qk_nope_head_dim=16, v_head_dim=16),
    # ample capacity: token dropping differs between full-sequence and
    # one-token routing
    "moe": dict(arch_type="moe", num_experts=4, experts_per_token=2, moe_d_ff=64,
                num_shared_experts=1, capacity_factor=8.0),
    "ssm": dict(arch_type="ssm", num_heads=0, num_kv_heads=0, d_ff=0,
                ssm_state=16, ssm_headdim=16, ssm_chunk=4),
    "hybrid": dict(arch_type="hybrid", ssm_state=16, ssm_headdim=16, ssm_chunk=4,
                   attn_every=2),
}


@pytest.mark.parametrize("family", sorted(_FAMILIES))
def test_decode_matches_forward(family):
    kw = dict(num_layers=3, d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
              vocab_size=97, dtype="float32", remat=False)
    kw.update(_FAMILIES[family])
    if family == "hybrid":
        kw["num_layers"] = 4
    cfg = TModelConfig(name=family, **kw)
    params = TT.init_model(torch.Generator().manual_seed(1), cfg, device="cpu")
    T, steps = 12, 3
    tok = torch.randint(0, cfg.vocab_size, (2, T + steps),
                        generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        full, _ = TT.forward(params, tok, cfg)
        _, cache = TT.prefill(params, tok[:, :T], cfg, max_len=T + steps)
        for s in range(steps):
            dl, cache = TT.decode_step(params, cache, tok[:, T + s:T + s + 1], cfg)
            np.testing.assert_allclose(dl[:, 0].numpy(), full[:, T + s].numpy(),
                                       rtol=2e-3, atol=2e-3)
