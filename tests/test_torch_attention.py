"""``flash_attention`` and ``cfg.remat``: the port against the reference.

The port's ``flash_attention`` (on the CPU its plain version, the
reference's chunked online softmax run tile by tile) against
``repro.models.attention.flash_attention`` on the same numpy inputs:
forward and the gradients of q, k and v (``jax.vjp`` against
``torch.autograd`` with the same cotangent). f32: forward at rtol 1e-5 /
atol 1e-6 and gradients at rtol 1e-4 / atol 1e-5, the reference's own
flash-vs-naive tolerance (``tests/test_models.py``). bf16: the forward
within one bf16 ulp of each value (both compute in f32 and round once);
each gradient entry within 4 bf16 ulps of itself plus one ulp of the
tensor's largest entry, and never more than 2^-6 of that largest entry:
the reference's backward rounds each tile's cotangents to bf16 and adds
k's and v's over the q tiles in bf16, each partial sum rounded at its own
scale (up to the largest entry's), where the port adds in f32 and rounds
once (measured at most 0.5 of that allowance).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.attention import flash_attention as j_flash
from repro_torch.configs import get_config as t_get
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attn import kernel as FA
from repro_torch.launch.steps import make_loss_fn
from repro_torch.models.attention import flash_attention
from repro_torch.models.transformer import init_model
from repro_torch.utils.tree import tree_flatten, tree_unflatten

torch.use_deterministic_algorithms(True)
torch.set_num_threads(2)

F32_FWD = dict(rtol=1e-5, atol=1e-6)
F32_GRAD = dict(rtol=1e-4, atol=1e-5)


def _inputs(B, T, S, H, Hkv, Dk, Dv, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, T, H, Dk), (B, S, Hkv, Dk), (B, S, Hkv, Dv), (B, T, H, Dv))]


def _reference(q, k, v, g, dtype, **kw):
    """The reference's output and vjp; a v narrower than q is padded to
    q's width and the pad sliced off (``mla_forward``)."""
    Dk, Dv = q.shape[-1], v.shape[-1]

    def f(q, k, v):
        if Dv < Dk:
            v = jnp.pad(v, ((0, 0), (0, 0), (0, 0), (0, Dk - Dv)))
        return j_flash(q, k, v, **kw)[..., :Dv]

    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    out, vjp = jax.vjp(f, *(jnp.asarray(x, jd) for x in (q, k, v)))
    grads = vjp(jnp.asarray(g, jd))
    return [np.asarray(jnp.asarray(a, jnp.float32)) for a in (out, *grads)]


def _port(q, k, v, g, dtype, **kw):
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    tq, tk, tv = (torch.from_numpy(x).to(td).requires_grad_(True) for x in (q, k, v))
    out = flash_attention(tq, tk, tv, **kw)
    assert out.dtype == td and out.shape == g.shape
    grads = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(g).to(td))
    for t, gr in zip((tq, tk, tv), grads):
        assert gr.dtype == td and gr.shape == t.shape
    return [a.detach().float().numpy() for a in (out, *grads)]


def _bf16_ulp(x):
    """One bf16 ulp at |x| (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), np.finfo(np.float32).tiny)))
    return np.exp2(e - 7)


# (B, T, S, H, Hkv, Dk, Dv, window, q_offset): 16-tiles, T = 64 unless stated
GRID = {
    "gqa1": (2, 64, 64, 4, 1, 16, 16, 0, 0),
    "gqa2": (2, 64, 64, 4, 2, 16, 16, 0, 0),
    "mha": (2, 64, 64, 4, 4, 16, 16, 0, 0),
    "window24": (2, 64, 64, 4, 2, 16, 16, 24, 0),
    "offset32": (2, 32, 64, 4, 2, 16, 16, 0, 32),
    "mla": (2, 64, 64, 4, 4, 24, 16, 0, 0),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(GRID))
def test_flash_attention_matches_reference(case, dtype):
    B, T, S, H, Hkv, Dk, Dv, window, q_offset = GRID[case]
    q, k, v, g = _inputs(B, T, S, H, Hkv, Dk, Dv)
    kw = dict(q_offset=q_offset, window=window, q_chunk=16, kv_chunk=16)
    ref = _reference(q, k, v, g, dtype, **kw)
    got = _port(q, k, v, g, dtype, **kw)
    if dtype == "float32":
        np.testing.assert_allclose(got[0], ref[0], **F32_FWD)
        for a, b in zip(got[1:], ref[1:]):
            np.testing.assert_allclose(a, b, **F32_GRAD)
    else:
        diff = np.abs(got[0] - ref[0])
        assert (diff <= _bf16_ulp(np.maximum(np.abs(got[0]), np.abs(ref[0])))).all()
        for a, b in zip(got[1:], ref[1:]):
            big = np.abs(b).max()
            allow = np.minimum(2.0**-6 * big,
                               4 * _bf16_ulp(np.maximum(np.abs(a), np.abs(b)))
                               + _bf16_ulp(big))
            assert (np.abs(a - b) <= allow).all()


def _whole_matrix(q, k, v, window=0):
    """Softmax over the whole [T, S] score matrix, in float64."""
    qf, kf, vf = (torch.from_numpy(x).double() for x in (q, k, v))
    G = qf.shape[2] // kf.shape[2]
    kf, vf = kf.repeat_interleave(G, 2), vf.repeat_interleave(G, 2)
    s = torch.einsum("bthd,bshd->bhts", qf, kf) / np.sqrt(q.shape[-1])
    pos = torch.arange(q.shape[1])
    mask = pos[:, None] >= pos[None, :]
    if window:
        mask &= pos[None, :] > pos[:, None] - window
    p = torch.softmax(s.masked_fill(~mask, -torch.inf), dim=-1)
    return torch.einsum("bhts,bshd->bthd", p, vf).numpy()


def test_ragged_length_is_answered_where_the_reference_raises():
    q, k, v, _ = _inputs(2, 24, 24, 4, 2, 16, 16, seed=3)
    with pytest.raises(AssertionError):
        j_flash(*(jnp.asarray(x) for x in (q, k, v)), q_chunk=16, kv_chunk=16)
    for window in (0, 10):
        got = flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                              window=window, q_chunk=16, kv_chunk=16)
        np.testing.assert_allclose(got.numpy(), _whole_matrix(q, k, v, window),
                                   rtol=1e-5, atol=1e-6)


def test_plain_version_keeps_no_score_matrix():
    """Forward and backward at T = S = 256 with 32-tiles: no tensor saved
    for the backward, by the function or by the sweeps it runs again,
    has T·S elements or more."""
    T = 256
    q, k, v, g = (torch.from_numpy(x).requires_grad_(True)
                  for x in _inputs(1, T, T, 2, 1, 16, 16, seed=5))
    saved = []

    def pack(t):
        saved.append(t.numel())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = flash_attention(q, k, v, q_chunk=32, kv_chunk=32)
        torch.autograd.grad(out, (q, k, v), g.detach())
    assert saved and max(saved) < T * T


def test_window_that_leaves_a_row_no_key_is_refused():
    q, k, v, _ = _inputs(1, 8, 8, 2, 2, 16, 16)
    with pytest.raises(ValueError, match="no key"):
        flash_attention(*(torch.from_numpy(x) for x in (q, k, v)), q_offset=20,
                        window=4)


def test_meta_tensors_get_shapes_and_report_the_reference_flops():
    """On ``meta`` the wrapper computes nothing and reports the dots as the
    reference's HLO walk counts them: 2·B·H·T·S·(Dk + Dv) forward, three
    times that backward; nothing counts as a launch."""
    B, T, H, Hkv, Dk, Dv = 2, 32768, 16, 16, 128, 128
    q = torch.empty((B, T, H, Dk), device="meta", requires_grad=True)
    k = torch.empty((B, T, Hkv, Dk), device="meta", requires_grad=True)
    v = torch.empty((B, T, Hkv, Dv), device="meta", requires_grad=True)
    seen = []
    observe = lambda name, nbytes, flops: seen.append((name, flops))
    fwd0, bwd0 = FA.flash_attn_fwd.launches, FA.flash_attn_bwd.launches
    _build.launch_observers.append(observe)
    try:
        out = flash_attention(q, k, v)
        grads = torch.autograd.grad(out, (q, k, v), torch.empty_like(out))
    finally:
        _build.launch_observers.remove(observe)
    assert out.shape == (B, T, H, Dv) and out.device.type == "meta"
    assert [g.shape for g in grads] == [q.shape, k.shape, v.shape]
    fwd = 2.0 * B * H * T * T * (Dk + Dv)
    assert seen == [("flash_attn_fwd", fwd), ("flash_attn_bwd", 3 * fwd)]
    assert (FA.flash_attn_fwd.launches, FA.flash_attn_bwd.launches) == (fwd0, bwd0)


@pytest.mark.parametrize("name", ["olmo-1b", "h2o-danube-3-4b", "zamba2-7b"])
def test_remat_changes_no_value(name):
    """Loss and every gradient leaf bitwise equal with ``remat`` on and off
    (f32, reduced): the checkpointed layers run the same ops again. With
    remat the forward keeps fewer elements for the backward."""
    base = dataclasses.replace(t_get(name).reduced(), dtype="float32")
    params = init_model(torch.Generator().manual_seed(0), base, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, base.vocab_size, (2, 24))).long()
    leaves, treedef = tree_flatten(params)
    results = []
    for remat in (False, True):
        cfg = dataclasses.replace(base, remat=remat)
        req = [l.detach().clone().requires_grad_(True) for l in leaves]
        kept = []
        with torch.autograd.graph.saved_tensors_hooks(
                lambda t: kept.append(t.numel()) or t, lambda t: t):
            loss, _ = make_loss_fn(cfg)(tree_unflatten(treedef, req), {"tokens": toks})
        grads = torch.autograd.grad(loss, req, allow_unused=True)
        results.append((loss, grads, sum(kept)))
    (l0, g0, kept0), (l1, g1, kept1) = results
    assert kept1 < kept0
    assert torch.equal(l0, l1)
    for a, b in zip(g0, g1):
        assert (a is None and b is None) or torch.equal(a, b)


def _split3(x):
    """The bf16 kernels' split of an f32 tile (``split3`` in
    ``csrc/flash_attn_sm90.cuh``) in the same arithmetic: hi = bf16_rn(x),
    mid = bf16_rn(x - hi), lo = bf16_rn(x - hi - mid), each subtraction in
    f32 (exact there) and each rounding to nearest even, as torch's
    ``bfloat16`` conversion and the card's ``cvt.rn.bf16x2.f32``."""
    hi = x.to(torch.bfloat16)
    r = x - hi.float()
    mid = r.to(torch.bfloat16)
    lo = (r - mid.float()).to(torch.bfloat16)
    return hi, mid, lo


# case -> (exponent range [lo, hi) of |x|, signed): P-like, dS-like, and
# values so small that lo falls under bf16's smallest subnormal (2^-133)
SPLIT_CASES = {"p_like": (-90, 0, False), "ds_like": (-90, 20, True),
               "below_2^-110": (-149, -110, True)}


@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
def test_three_bf16_parts_hold_an_f32_value_exactly(case):
    """hi + mid + lo == x bit for bit in f64 on f32's normal range, so the
    three bf16 x bf16 products of the split with any bf16 v add up to x·v
    exactly (in f64); below 2^-110 the error stays <= 2^-134 absolute."""
    lo_e, hi_e, signed = SPLIT_CASES[case]
    rng = np.random.default_rng(23)
    n = 1 << 17
    mant = 1.0 + rng.integers(0, 1 << 23, n) / float(1 << 23)
    x = np.ldexp(mant, rng.integers(lo_e, hi_e, n))
    if signed:
        x *= rng.choice([-1.0, 1.0], n)
    x = torch.from_numpy(x.astype(np.float32))
    if case == "p_like":
        x[0] = 1.0  # the largest P
    parts = [p.double() for p in _split3(x)]
    total, xd = parts[0] + parts[1] + parts[2], x.double()
    if case == "below_2^-110":
        assert float((total - xd).abs().max()) <= 2.0**-134
        return
    assert torch.equal(total, xd)
    v = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(torch.bfloat16).double()
    assert torch.equal(parts[0] * v + parts[1] * v + parts[2] * v, xd * v)
