"""Shared NN primitives: norms, RoPE, activations, initializers.

The port of ``repro.models.common``: params are plain dicts of tensors,
per-layer params stack on a leading axis, and the math keeps the
reference's dtypes (norm and RoPE in f32, cast back to the input dtype).
Initializers draw from an explicit ``torch.Generator``; its numbers are
not jax's, so parity tests carry weights across with ``utils.convert``.
"""
from __future__ import annotations

import functools
import math
from contextlib import contextmanager

import torch
import torch.nn.functional as F

from repro_torch.device import resolve

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


# ---------------------------------------------------------------------------
# Activation sharding hints
# ---------------------------------------------------------------------------
# The reference's launch code names the mesh axes of the activations' batch
# dim at trace time, and its model code pins that sharding at block
# boundaries, hints to XLA's GSPMD partitioner. The port has no partitioner
# (each rank runs its own unpartitioned program on the blocks it holds), so
# both names are kept for code written against the reference and do
# nothing; the port's step builders do not call them.


@contextmanager
def activation_sharding(axes):
    """A no-op: ``axes`` (the mesh axes of the batch dim) has nothing to
    constrain in the port."""
    yield


def shard_batch(x):
    """``x`` unchanged (see ``activation_sharding``)."""
    return x


def dense_init(gen, shape, dtype, scale, device):
    """normal * scale, drawn in f32 and cast, like ``dense_init``; ``shape``
    may carry leading stack axes ([L, d_in, d_out])."""
    w = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    return w.mul_(scale).to(dtype)  # scaled in place: one f32 copy at a time


def default_scale(d_in: int) -> float:
    return 1.0 / math.sqrt(d_in)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def init_norm(cfg, d, lead=(), device=None):
    device = resolve(device)
    shape = tuple(lead)
    if cfg.norm_type == "rmsnorm":
        return {"scale": torch.ones(shape + (d,), device=device)}
    if cfg.norm_type == "layernorm":
        return {"scale": torch.ones(shape + (d,), device=device),
                "bias": torch.zeros(shape + (d,), device=device)}
    if cfg.norm_type == "nonparametric_ln":
        # placeholder leaf, as in the reference: it is part of Q
        return {"_np": torch.zeros(shape + (1,), device=device)}
    raise ValueError(cfg.norm_type)


def apply_norm(p, x, cfg):
    xf = x.float()
    if cfg.norm_type == "rmsnorm":
        rms = torch.sqrt((xf * xf).mean(-1, keepdim=True) + cfg.norm_eps)
        return ((xf / rms) * p["scale"]).to(x.dtype)
    mu = xf.mean(-1, keepdim=True)
    c = xf - mu
    var = (c * c).mean(-1, keepdim=True)
    y = c / torch.sqrt(var + cfg.norm_eps)
    if cfg.norm_type == "layernorm":
        y = y * p["scale"] + p["bias"]
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# Activations and RoPE
# ---------------------------------------------------------------------------


def _gelu(x):
    # jax.nn.gelu defaults to the tanh approximation, not the exact erf form
    return F.gelu(x, approximate="tanh")


def act_fn(name: str):
    return {"silu": F.silu, "gelu": _gelu, "relu": F.relu}[name]


@functools.lru_cache(maxsize=None)
def _inv_freq(dim, theta, device):
    exps = torch.arange(0, dim, 2, dtype=torch.float32) / dim
    return (1.0 / theta ** exps.double()).float().to(device)


def rope_inv_freq(dim, theta, device=None):
    """[dim//2] f32, the reference's table bit for bit as its jitted steps
    use it: XLA folds the constant ``1 / theta ** exps`` at compile time in
    f64 and rounds it once to f32 (the correctly rounded table), where
    torch's f32 ``pow`` and division are an ulp off at some entries of most
    widths (112 and 120 among them). The angle ``position * inv_freq`` grows
    that ulp with the position: at long_500k's it moves cos / sin by 3e-2.
    The table is computed on the CPU, once a device, and moved there: CUDA
    divides by a scalar through its reciprocal, which moves ``exps``."""
    return _inv_freq(int(dim), float(theta), torch.device(device or "cpu"))


def rope_angles(positions, dim, theta):
    """positions [*P] -> (cos, sin) each [*P, dim//2] in f32."""
    ang = positions.float()[..., None] * rope_inv_freq(dim, theta, positions.device)
    return torch.cos(ang), torch.sin(ang)


def yarn_correction_range(dim, theta, beta_fast, beta_slow, original_max_pos):
    """(low, high): the frequency pairs where YaRN's ramp starts and ends,
    from the rotations ``beta_fast`` and ``beta_slow`` over the original
    context (``yarn_find_correction_range`` of DeepSeek-V2's modelling code)."""
    def pair(rotations):
        return (dim * math.log(original_max_pos / (rotations * 2 * math.pi))
                / (2 * math.log(theta)))
    return max(math.floor(pair(beta_fast)), 0), min(math.ceil(pair(beta_slow)), dim - 1)


def yarn_mscale(factor, mscale):
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


@functools.lru_cache(maxsize=None)
def _yarn_inv_freq(dim, theta, factor, beta_fast, beta_slow, original_max_pos, device):
    low, high = yarn_correction_range(dim, theta, beta_fast, beta_slow, original_max_pos)
    high = high + 0.001 if low == high else high
    i = torch.arange(dim // 2, dtype=torch.float64)
    ramp = ((i - low) / (high - low)).clamp(0.0, 1.0)
    extra = 1.0 / theta ** (torch.arange(0, dim, 2, dtype=torch.float64) / dim)
    inv = extra / factor * ramp + extra * (1.0 - ramp)
    return inv.float().to(device)


def model_rope_angles(positions, dim, cfg):
    """``rope_angles`` at ``cfg``'s RoPE: plain, or YaRN where
    ``cfg.yarn_factor`` is set (``DeepseekV2YarnRotaryEmbedding``: between
    the correction range's ends each pair's frequency ramps from θ^(-2i/dim)
    to it over the factor; cos and sin times mscale over mscale_all_dim).
    The table is computed in f64 on the CPU and rounded once, as
    ``rope_inv_freq``'s, and kept on each device it is asked for."""
    if not cfg.yarn_factor:
        return rope_angles(positions, dim, cfg.rope_theta)
    inv = _yarn_inv_freq(int(dim), float(cfg.rope_theta), float(cfg.yarn_factor),
                         float(cfg.yarn_beta_fast), float(cfg.yarn_beta_slow),
                         int(cfg.yarn_original_max_pos), positions.device)
    ang = positions.float()[..., None] * inv
    m = (yarn_mscale(cfg.yarn_factor, cfg.yarn_mscale)
         / yarn_mscale(cfg.yarn_factor, cfg.yarn_mscale_all_dim))
    if m == 1.0:
        return torch.cos(ang), torch.sin(ang)
    return torch.cos(ang) * m, torch.sin(ang) * m


def mla_softmax_scale(cfg):
    """MLA's score scale where it is not attention's default 1/√(dn + dr)
    (None there): that default times YaRN's mscale(factor, mscale_all_dim)
    squared, where YaRN is on and ``mscale_all_dim`` set."""
    if not (cfg.yarn_factor and cfg.yarn_mscale_all_dim):
        return None
    m = yarn_mscale(cfg.yarn_factor, cfg.yarn_mscale_all_dim)
    return 1.0 / math.sqrt(cfg.qk_nope_head_dim + cfg.qk_rope_head_dim) * m * m


def apply_rope(x, cos, sin):
    """x [..., T, H, D]; cos/sin [T, D//2], broadcast over batch/heads."""
    d2 = x.shape[-1] // 2
    xf1, xf2 = x[..., :d2].float(), x[..., d2:].float()
    c = cos[..., :, None, :]
    s = sin[..., :, None, :]
    return torch.cat([xf1 * c - xf2 * s, xf2 * c + xf1 * s], dim=-1).to(x.dtype)
