"""Decode attention (``kernels.decode_attn``) and RoPE at long positions: the
port against the reference on the same seeded inputs.

* ``decode_attn_plain`` against the reference's ``decode_attention``, and
  the port's ``mla_decode`` (whose latent part is ``mla_decode_attn_plain``
  on the CPU) against the reference's ``mla_decode``: f32 at rtol 1e-5 /
  atol 1e-6 (the same f32 function, sums in another order); bf16 within
  one bf16 ulp (rtol 2^-7) of the reference's rounded result.
* The wrappers: a CPU tensor goes to the plain version and counts no
  launch; ``meta`` tensors get the output's shape and report the
  reference's dot flops (the dry-run's decode flops are those of the
  plain version's einsums); refusals raise ``ValueError`` on every device.
* ``decode_step`` of both packages from the same seeded cache in f32 model
  math, at decode_32k's 32,768 slots and long_500k's positions (the
  sliding-window ring wrapped 8,000 times): ``pos`` and ``slot_pos`` exact,
  logits and caches at rtol / atol 1e-4 (``tests/test_torch_cache.py``'s).
* RoPE: ``inv_freq`` and the angles the reference's bit for bit at every
  head width the configs use (112 and 120 among them, where torch's f32
  ``pow`` alone is one ulp off), cos / sin within 1.2e-7.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get
from repro.models import attention as JA
from repro.models import common as JC
from repro.models import transformer as JT
from repro_torch.configs.base import ModelConfig as TModelConfig
from repro_torch.kernels import _build
from repro_torch.kernels.decode_attn import kernel as K
from repro_torch.models import attention as TA
from repro_torch.models import common as TC
from repro_torch.models import transformer as TT
from repro_torch.utils.convert import params_from_numpy

torch.set_num_threads(2)

F32_TOL = dict(rtol=1e-5, atol=1e-6)
BF16_TOL = dict(rtol=2.0 ** -7, atol=1e-6)  # one bf16 ulp of the larger value
STEP_TOL = dict(rtol=1e-4, atol=1e-4)


def _slots(kind, B, S, window=0):
    """(slot_pos [B, S], q_pos [B]) int64 of a cache state."""
    if kind == "full":  # positions 0 .. S-4 in place, the last 3 slots empty
        sp = np.tile(np.arange(S), (B, 1))
        sp[:, S - 3:] = -1
        return sp, np.full(B, S - 3)
    if kind == "ring":  # a wrapped ring: the last S positions at pos mod S
        q = 5 * S + 7
        p = np.arange(q - S + 1, q + 1)
        sp = np.empty(S, np.int64)
        sp[p % S] = p
        return np.tile(sp, (B, 1)), np.full(B, q)
    if kind == "empty":  # no valid slot: the reference averages v over all S
        return np.full((B, S), -1), np.full(B, 3)
    raise ValueError(kind)


# (name, B, S, H, Hkv, D, window, slots)
GQA_CASES = [
    ("g1 d128", 2, 96, 4, 4, 128, 0, "full"),
    ("g4 d120 window ring", 2, 64, 8, 2, 120, 64, "ring"),
    ("g12 d64", 1, 80, 12, 1, 64, 0, "full"),
    ("g48 d128", 1, 40, 48, 1, 128, 0, "full"),
    ("g4 d112 window", 2, 100, 4, 1, 112, 30, "full"),
    ("g2 d64 empty", 2, 20, 4, 2, 64, 0, "empty"),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", GQA_CASES, ids=[c[0] for c in GQA_CASES])
def test_decode_attn_plain_matches_reference(case, dtype):
    _, B, S, H, Hkv, D, window, kind = case
    rng = np.random.default_rng(7)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, 1, H, D), (B, S, Hkv, D), (B, S, Hkv, D)))
    sp, qp = _slots(kind, B, S, window)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    want = JA.decode_attention(*(jnp.asarray(a).astype(jdt) for a in (q, k, v)),
                               jnp.asarray(sp), jnp.asarray(qp), window=window)
    got = K.decode_attn_plain(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
                              torch.from_numpy(sp), torch.from_numpy(qp), window=window)
    assert got.dtype == tdt and got.shape == (B, 1, H, D)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               **(F32_TOL if dtype == "float32" else BF16_TOL))


def _mla_cfg(dtype):
    return dataclasses.replace(j_get("deepseek-v2-236b").reduced(), dtype=dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["full", "empty"])
def test_mla_decode_matches_reference(kind, dtype):
    """The reference's ``mla_decode`` (its latent einsums at ``:252-260``)
    against the port's, whose latent part is ``mla_decode_attn``, on one
    layer's weights and a seeded latent cache."""
    cfg = _mla_cfg(dtype)
    B, S = 2, 72
    lp = JA.init_mla(jax.random.PRNGKey(0), cfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, lp), "cpu")
    rng = np.random.default_rng(11)
    x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    ckv = rng.standard_normal((B, S, cfg.kv_lora_rank)).astype(np.float32)
    kr = rng.standard_normal((B, S, cfg.qk_rope_head_dim)).astype(np.float32)
    sp, pos = _slots(kind, B, S)
    slot = np.minimum(pos, S - 1)
    sp[np.arange(B), slot] = pos
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jo, jckv, jkr = JA.mla_decode(lp, jnp.asarray(x, jdt), jnp.asarray(ckv, jdt),
                                  jnp.asarray(kr, jdt), jnp.asarray(sp), jnp.asarray(slot),
                                  jnp.asarray(pos), cfg)
    tckv, tkr = torch.from_numpy(ckv).to(tdt), torch.from_numpy(kr).to(tdt)
    to, _, _ = TA.mla_decode(tp, torch.from_numpy(x).to(tdt), tckv, tkr,
                             torch.from_numpy(sp), torch.from_numpy(slot),
                             torch.from_numpy(pos), TModelConfig(**dataclasses.asdict(cfg)))
    tol = dict(rtol=1e-4, atol=1e-5) if dtype == "float32" else dict(rtol=2e-2, atol=2e-3)
    for got, want in ((tckv, jckv), (tkr, jkr), (to, jo)):  # the new slot's norm rounds
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)


def _gqa_operands(device, dtype=torch.float32, B=2, S=24, H=4, Hkv=2, D=16):
    g = torch.Generator().manual_seed(3)
    q = torch.randn(B, 1, H, D, generator=g).to(dtype)
    k = torch.randn(B, S, Hkv, D, generator=g).to(dtype)
    v = torch.randn(B, S, Hkv, D, generator=g).to(dtype)
    sp = torch.arange(S).repeat(B, 1)
    qp = torch.full((B,), S - 1)
    return tuple(t.to(device) for t in (q, k, v, sp, qp))


def _mla_operands(device, dtype=torch.float32, B=2, S=24, H=4, r=32, dr=8):
    g = torch.Generator().manual_seed(4)
    qa, qr = torch.randn(B, H, r, generator=g), torch.randn(B, H, dr, generator=g)
    ckv, kr = torch.randn(B, S, r, generator=g), torch.randn(B, S, dr, generator=g)
    sp, pos = torch.arange(S).repeat(B, 1), torch.full((B,), S - 1)
    return tuple(t.to(device).to(dtype) if t.is_floating_point() else t.to(device)
                 for t in (qa, qr, ckv, kr, sp, pos))


def test_cpu_tensors_take_the_plain_versions():
    gqa, mla = _gqa_operands("cpu"), _mla_operands("cpu")
    launches = K.decode_attn.launches, K.mla_decode_attn.launches
    assert torch.equal(K.decode_attn(*gqa, window=5), K.decode_attn_plain(*gqa, window=5))
    assert torch.equal(K.mla_decode_attn(*mla, qk_head_dim=24),
                       K.mla_decode_attn_plain(*mla, qk_head_dim=24))
    assert (K.decode_attn.launches, K.mla_decode_attn.launches) == launches


def test_meta_tensors_report_the_reference_dot_flops():
    seen = []
    _build.launch_observers.append(lambda name, nbytes, flops: seen.append((name, flops)))
    try:
        out = K.decode_attn(*_gqa_operands("meta"))
        lat = K.mla_decode_attn(*_mla_operands("meta"), qk_head_dim=24)
    finally:
        _build.launch_observers.pop()
    assert out.shape == (2, 1, 4, 16) and out.device.type == "meta"
    assert lat.shape == (2, 4, 32)
    # 2·B·H·S·D for q·kᵀ and p·v; 2·B·H·S·(r + dr) + 2·B·H·S·r
    assert seen == [("decode_attn", 4.0 * 2 * 4 * 24 * 16),
                    ("mla_decode_attn", 2.0 * 2 * 4 * 24 * (2 * 32 + 8))]


_ATTN_ARCHS = ["dbrx-132b", "deepseek-v2-236b", "granite-34b", "h2o-danube-3-4b",
               "llava-next-34b", "musicgen-medium", "olmo-1b", "starcoder2-3b",
               "zamba2-7b"]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("arch", _ATTN_ARCHS)
def test_route_picks_the_tensor_cores_for_bf16_mla_and_g_at_least_2(arch, dtype):
    """Every attention config at its decode widths: bf16 MLA and bf16 GQA
    with G >= 2 take the tensor-core kernel; f32 and G = 1 the CUDA-core
    kernel (olmo-1b, musicgen-medium and zamba2-7b's shared block)."""
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    if cfg.use_mla:
        got = K.route(dtype, (cfg.kv_lora_rank, cfg.qk_rope_head_dim))
        tc = True
    else:
        G = cfg.num_heads // cfg.num_kv_heads
        got = K.route(dtype, (cfg.resolved_head_dim,), G)
        tc = G >= 2
    assert got == (K.TENSOR_CORES if tc and dtype == torch.bfloat16 else K.CUDA_CORES)


@pytest.mark.parametrize("widths,group", [
    ((36,), 4), ((132,), 4), ((256,), 8), ((4,), 2),  # GQA: not a multiple of 8, too wide
    ((520, 64), None), ((512, 72), None), ((512, 20), None), ((512, 4), None),  # MLA
])
def test_route_keeps_the_widths_the_tensor_cores_lack_on_the_cuda_cores(widths, group):
    assert K.route(torch.bfloat16, widths, group) == K.CUDA_CORES
    with pytest.raises(ValueError, match="tensor-core kernel"):
        if group is None:
            r, dr = widths
            K.mla_decode_attn_tc(*_mla_operands("meta", torch.bfloat16, r=r, dr=dr),
                                 qk_head_dim=24)
        else:
            K.decode_attn_tc(*_gqa_operands("meta", torch.bfloat16, H=2 * group, D=widths[0]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_meta_tensors_report_the_dot_flops_on_both_routes(dtype):
    """f32 and G = 1 report as the CUDA-core kernels, bf16 G >= 2 and bf16 MLA
    as the tensor-core kernels; every one the reference's dot flops, and
    ``cuda_cores`` reports the CUDA-core kernel whatever the route."""
    seen = []
    _build.launch_observers.append(lambda name, nbytes, flops: seen.append((name, flops)))
    try:
        K.decode_attn(*_gqa_operands("meta", dtype))  # G = 2
        K.decode_attn(*_gqa_operands("meta", dtype, Hkv=4))  # G = 1
        K.decode_attn(*_gqa_operands("meta", dtype), cuda_cores=True)
        K.mla_decode_attn(*_mla_operands("meta", dtype), qk_head_dim=24)
        K.mla_decode_attn(*_mla_operands("meta", dtype), qk_head_dim=24, cuda_cores=True)
    finally:
        _build.launch_observers.pop()
    tc = "_tc" if dtype == torch.bfloat16 else ""
    gqa, mla = 4.0 * 2 * 4 * 24 * 16, 2.0 * 2 * 4 * 24 * (2 * 32 + 8)
    assert seen == [("decode_attn" + tc, gqa), ("decode_attn", gqa), ("decode_attn", gqa),
                    ("mla_decode_attn" + tc, mla), ("mla_decode_attn", mla)]


def test_tensor_core_wrappers_take_the_plain_versions_on_the_cpu():
    gqa = _gqa_operands("cpu", torch.bfloat16)
    mla = _mla_operands("cpu", torch.bfloat16)
    launches = K.decode_attn_tc.launches, K.mla_decode_attn_tc.launches
    assert torch.equal(K.decode_attn_tc(*gqa, window=5),
                       K.decode_attn_plain(*gqa, window=5))
    assert torch.equal(K.mla_decode_attn_tc(*mla, qk_head_dim=24),
                       K.mla_decode_attn_plain(*mla, qk_head_dim=24))
    assert (K.decode_attn_tc.launches, K.mla_decode_attn_tc.launches) == launches
    with pytest.raises(ValueError, match="tensor-core kernel"):  # f32
        K.decode_attn_tc(*_gqa_operands("cpu"))
    with pytest.raises(ValueError, match="tensor-core kernel"):  # G = 1
        K.decode_attn_tc(*_gqa_operands("cpu", torch.bfloat16, Hkv=4))


@pytest.mark.parametrize("arch", ["olmo-1b", "h2o-danube-3-4b", "deepseek-v2-236b",
                                  "zamba2-7b"])
def test_dryrun_decode_flops_are_the_plain_versions(arch, monkeypatch):
    """The decode step's flops on ``meta`` tensors at decode_32k's shape (the
    dry-run's count): the kernels' reported flops equal what the op counter
    counts on the plain versions' einsums."""
    from repro_torch.configs import get_config
    from repro_torch.launch import op_cost, steps

    cfg = get_config(arch).reduced()
    args = (steps.model_shapes(cfg), TT.init_cache(cfg, 4, 32768, device="meta"),
            torch.zeros((4, 1), dtype=torch.int64, device="meta"))
    step = steps.build_decode_step(cfg)
    flops, _ = op_cost.step_costs(step, *args)
    monkeypatch.setattr(TA, "decode_attn", K.decode_attn_plain)
    monkeypatch.setattr(TA, "mla_decode_attn", K.mla_decode_attn_plain)
    args = (steps.model_shapes(cfg), TT.init_cache(cfg, 4, 32768, device="meta"),
            torch.zeros((4, 1), dtype=torch.int64, device="meta"))
    plain, _ = op_cost.step_costs(step, *args)
    assert flops == plain > 0


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_decode_wrappers_refuse_what_the_kernels_do_not_take(device):
    q, k, v, sp, qp = _gqa_operands(device)
    bad = [
        (q.double(), k.double(), v.double(), sp, qp),  # type
        (q, k.to(torch.bfloat16), v, sp, qp),  # mixed types
        (q[:, :, :3], k, v, sp, qp),  # 3 q heads over 2 kv heads
        (torch.cat([q, q], 1), k, v, sp, qp),  # two query tokens
        (q, k.transpose(1, 2).contiguous().transpose(1, 2), v, sp, qp),  # layout
        (q, k, v, sp.int(), qp),  # slot_pos type
        (q, k, v, sp[:, :5], qp),  # slot_pos shape
        (q[..., :15], k[..., :15], v[..., :15], sp, qp),  # odd head dim
    ]
    for ops in bad:
        with pytest.raises(ValueError):
            K.decode_attn(*ops)
    with pytest.raises(ValueError):
        K.decode_attn(q, k, v, sp, qp, window=-1)
    for fn in (K.decode_attn, K.decode_attn_tc):  # bf16: either kernel's route
        qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
        for ops in [(qb[:, :, :3], kb, vb, sp, qp), (qb, kb, vb, sp[:, :5], qp),
                    (qb[..., :15], kb[..., :15], vb[..., :15], sp, qp)]:
            with pytest.raises(ValueError):
                fn(*ops)
    qa, qr, ckv, kr, sp, pos = _mla_operands(device)
    for ops in [(qa, qr[:, :1], ckv, kr, sp, pos),  # q_rope heads
                (qa[..., :30], qr, ckv[..., :30], kr, sp, pos),  # r not 16 bytes
                (qa, qr, ckv, kr.double(), sp, pos),
                (qa, qr, ckv.transpose(0, 1).contiguous().transpose(0, 1), kr, sp, pos)]:
        with pytest.raises(ValueError):
            K.mla_decode_attn(*ops, qk_head_dim=24)


# ---- decode_step of both packages from one seeded cache (f32 model math) --


def _seeded_cache(cfg, B, S, slot_pos, pos, seed):
    """The reference's and the port's caches of ``cfg`` holding the same
    seeded entries, ``slot_pos`` and ``pos``."""
    rng = np.random.default_rng(seed)
    jc = JT.init_cache(cfg, B, S)
    host = {}
    for name, a in jc.items():
        if name == "pos":
            host[name] = np.asarray(pos, np.int64)
        elif name == "slot_pos":
            host[name] = np.asarray(slot_pos, np.int64)
        else:
            host[name] = rng.standard_normal(a.shape, dtype=np.float32)
    jc = {n: jnp.asarray(a, jc[n].dtype) for n, a in host.items()}
    tc = {n: torch.from_numpy(a.copy()) for n, a in host.items()}
    return jc, tc


def _step_parity(cfg, B, S, slot_pos, pos, steps=2):
    jp = JT.init_model(jax.random.PRNGKey(0), cfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    tcfg = TModelConfig(**dataclasses.asdict(cfg))
    jc, tc = _seeded_cache(cfg, B, S, slot_pos, pos, seed=5)
    toks = np.random.default_rng(6).integers(0, cfg.vocab_size, (steps, B, 1))
    jdec = jax.jit(lambda p, c, t: JT.decode_step(p, c, t, cfg))
    V = cfg.vocab_size
    for t in toks:
        jl, jc = jdec(jp, jc, jnp.asarray(t, jnp.int32))
        with torch.no_grad():
            tl, tc = TT.decode_step(tp, tc, torch.from_numpy(t), tcfg)
        np.testing.assert_allclose(tl.numpy()[..., :V], np.asarray(jl)[..., :V], **STEP_TOL)
        for name, a in jc.items():
            if name in ("pos", "slot_pos"):
                np.testing.assert_array_equal(tc[name].numpy(), np.asarray(a), err_msg=name)
            else:
                np.testing.assert_allclose(tc[name].numpy(), np.asarray(a), err_msg=name,
                                           **STEP_TOL)
    return tc


def _f32(name, **kw):
    return dataclasses.replace(j_get(name).reduced(), dtype="float32", **kw)


def test_decode_step_at_decode_32k_matches_reference():
    """Reduced olmo-1b against 32,768 slots, a 32,760-token context: slots
    0 .. 32,759 hold their positions, the last 8 are empty."""
    S, B = 32768, 2
    sp = np.tile(np.arange(S), (B, 1))
    sp[:, 32760:] = -1
    tc = _step_parity(_f32("olmo-1b"), B, S, sp, np.full(B, 32760))
    assert tc["pos"].tolist() == [32762] * B


@pytest.mark.parametrize("arch,head_dim", [("h2o-danube-3-4b", 120), ("zamba2-7b", 112)])
def test_decode_step_at_long_500k_matches_reference(arch, head_dim):
    """Reduced danube3-4b and zamba2-7b with their published head widths
    (where torch's f32 ``pow`` alone misses the reference's RoPE table), the
    reduced 64-slot ring holding the last 64 of a 524,280-token context."""
    cfg = _f32(arch, head_dim=head_dim)
    B, S, q = 1, cfg.sliding_window, 524280
    p = np.arange(q - S, q)
    sp = np.empty(S, np.int64)
    sp[p % S] = p
    tc = _step_parity(cfg, B, S, np.tile(sp, (B, 1)), np.full(B, q))
    assert sorted(tc["slot_pos"][0].tolist()) == list(range(q + 2 - S, q + 2))


def test_decode_step_of_mamba2_matches_reference():
    """Reduced mamba2-780m: its O(1) state, seeded, at long_500k's position."""
    cfg = _f32("mamba2-780m")
    tc = _step_parity(cfg, 2, 0, None, np.full(2, 524280))
    assert "slot_pos" not in tc


# ---- RoPE ------------------------------------------------------------------


def _reference_inv_freq(dim, theta):
    """The reference's table (``repro/models/common.py:101``) as its jitted
    steps compute it (XLA folds the constant; eager jnp rounds the power
    first, an ulp off the jitted table at some entries of every width)."""
    return jax.jit(lambda: 1.0 / (theta ** (jnp.arange(0, dim, 2, dtype=jnp.float32)
                                            / dim)))()


@pytest.mark.parametrize("dim", [16, 32, 64, 96, 112, 120, 128, 192])
def test_rope_matches_reference_bit_for_bit(dim):
    """``inv_freq`` and the angles at long_500k's positions bit for bit, and
    cos / sin within 1.2e-7, against the reference's jitted ``rope_angles``
    (as ``decode_step`` runs it)."""
    theta = 10000.0
    jinv = _reference_inv_freq(dim, theta)
    np.testing.assert_array_equal(TC.rope_inv_freq(dim, theta).numpy(), np.asarray(jinv))
    pos = np.arange(520192, 524289)
    jang = jax.jit(lambda p: p.astype(jnp.float32)[..., None] * jinv)(jnp.asarray(pos))
    tang = torch.from_numpy(pos).float()[..., None] * TC.rope_inv_freq(dim, theta)
    np.testing.assert_array_equal(tang.numpy(), np.asarray(jang))
    jcos, jsin = jax.jit(lambda p: JC.rope_angles(p, dim, theta))(jnp.asarray(pos))
    tcos, tsin = TC.rope_angles(torch.from_numpy(pos), dim, theta)
    np.testing.assert_allclose(tcos.numpy(), np.asarray(jcos), rtol=0, atol=1.2e-7)
    np.testing.assert_allclose(tsin.numpy(), np.asarray(jsin), rtol=0, atol=1.2e-7)
