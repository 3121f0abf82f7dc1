"""Dense transformer assembly: embedding, layer stack, tied LM head.

The dense path of ``repro.models.transformer``: per-layer params stack on
a leading L axis and a Python loop over layers stands in for
``lax.scan``. ``embed`` is padded to ``padded_vocab`` and the padded
logit columns are masked to -1e30. ``cfg.remat`` is ignored: it changes
memory, not values, and the port's sizes fit without recomputation.
MoE, SSM, hybrid, frontends and decode wait for ROADMAP Queue 1 item 15.
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve
from repro_torch.models import attention as attn
from repro_torch.models.common import (
    apply_norm, dense_init, init_norm, torch_dtype,
)
from repro_torch.models.mlp import init_mlp, mlp_forward
from repro_torch.utils.tree import tree_map

_FAMILY_TODO = ("only the dense GQA transformer is ported; {what} waits for "
                "ROADMAP Queue 1 item 15")


def _check_dense(cfg):
    if cfg.arch_type != "dense" or cfg.use_mla or cfg.num_experts:
        raise NotImplementedError(_FAMILY_TODO.format(what=cfg.arch_type))
    if cfg.frontend != "none":
        raise NotImplementedError(_FAMILY_TODO.format(what="a frontend"))


def padded_vocab(cfg) -> int:
    """Vocab rounded up to a multiple of 512 (``transformer.padded_vocab``)."""
    if cfg.vocab_size % 512 == 0 or cfg.vocab_size < 512:
        return cfg.vocab_size
    return -(-cfg.vocab_size // 512) * 512


def init_model(gen: torch.Generator, cfg, device=None):
    """Random params from ``gen`` in the reference's tree layout, on the
    card unless ``device`` names another (``device.resolve``)."""
    _check_dense(cfg)
    device = resolve(device)
    dt = torch_dtype(cfg.dtype)
    L = (cfg.num_layers,)
    params = {"embed": dense_init(gen, (padded_vocab(cfg), cfg.d_model), dt,
                                  0.02, device)}
    params["blocks"] = {
        "norm1": init_norm(cfg, cfg.d_model, L, device),
        "norm2": init_norm(cfg, cfg.d_model, L, device),
        "attn": attn.init_gqa(gen, cfg, L, device),
        "ffn": init_mlp(gen, cfg, L, device),
    }
    params["final_norm"] = init_norm(cfg, cfg.d_model, (), device)
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(
            gen, (cfg.d_model, padded_vocab(cfg)), dt, 0.02, device)
    return params


def _apply_attn_block(p, x, cfg):
    h = apply_norm(p["norm1"], x, cfg)
    x = x + attn.gqa_forward(p["attn"], h, cfg)
    h = apply_norm(p["norm2"], x, cfg)
    return x + mlp_forward(p["ffn"], h, cfg)


def _logits(params, x, cfg):
    x = apply_norm(params["final_norm"], x, cfg)
    head = params["embed"].t() if cfg.tie_embeddings else params["lm_head"]
    logits = x @ head
    Vp = logits.shape[-1]
    if Vp != cfg.vocab_size:
        pad = torch.arange(Vp, device=logits.device) >= cfg.vocab_size
        logits = logits.masked_fill(pad, -1e30)
    return logits


def forward(params, tokens, cfg):
    """tokens [B, T] int -> (logits [B, T, Vp], aux_loss scalar 0)."""
    _check_dense(cfg)
    x = params["embed"][tokens]
    for layer in range(cfg.num_layers):
        lp = tree_map(lambda a: a[layer], params["blocks"])
        x = _apply_attn_block(lp, x, cfg)
    return _logits(params, x, cfg), torch.zeros((), device=x.device)
