"""Model assembly: embedding, layer stack, LM head, decode; the port of
``repro.models.transformer`` for every architecture family:

  dense   -- GQA attention + (gated) FFN        (olmo, granite, danube,
                                                 starcoder2, musicgen*, llava*)
  moe     -- GQA or MLA attention + routed FFN  (dbrx, deepseek-v2; the
             ``first_k_dense`` leading blocks with a dense FFN stack
             apart, as ``dense_blocks``)
  ssm     -- Mamba2 (SSD) mixer, attention-free (mamba2-780m)
  hybrid  -- Mamba2 stack + ONE shared attention
             block applied every ``attn_every`` (zamba2)
  (*audio/vlm: dense backbone + stub frontend embeddings)

Per-layer params stack on a leading L axis and a Python loop over layers
stands in for ``lax.scan``. A hybrid model is split into static segments
(a shared-attention site, then a run of mamba layers), so the shared
block's KV cache exists only at its sites; its one parameter set serves
every site, so autograd sums its gradient over them. ``embed`` is padded
to ``padded_vocab`` and the padded logit columns are masked to -1e30.
``cfg.remat`` checkpoints each layer body (attention block, mamba block,
the hybrid's shared block) where grad is enabled, as the reference's
``jax.checkpoint`` of its scan bodies: autograd keeps each layer's input,
and the backward runs the layer again. It changes memory, not values.

Two behaviours of the reference's cache are kept as they are. ``prefill``
without ``max_len`` sizes the cache to the prompt, so ``decode_step``
writes every new token into slot ``min(pos, S - 1)`` (a sliding-window
model into ``pos % S``, the oldest), overwriting a prompt entry. And a
prompt slot beyond the cache (``max_len`` below the prompt plus the
frontend tokens) is dropped, as jax's scatter drops an out-of-range index.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve
from repro_torch.models import attention as attn
from repro_torch.models import mamba2 as m2
from repro_torch.models.common import (
    apply_norm, default_scale, dense_init, init_norm, torch_dtype,
)
from repro_torch.models.mlp import init_mlp, mlp_forward
from repro_torch.models.moe import init_moe, moe_forward
from repro_torch.utils.tree import tree_map


def _layer(tree, i):
    return tree_map(lambda a: a[i], tree)


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def _init_attn_block(gen, cfg, lead, device, dense=False):
    """A stack of attention blocks; ``dense``: the leading blocks' dense FFN
    of ``d_ff`` in an MoE model (``cfg.first_k_dense``)."""
    moe = cfg.num_experts and not dense
    return {
        "norm1": init_norm(cfg, cfg.d_model, lead, device),
        "norm2": init_norm(cfg, cfg.d_model, lead, device),
        "attn": (attn.init_mla if cfg.use_mla else attn.init_gqa)(
            gen, cfg, lead, device),
        "ffn": (init_moe if moe else init_mlp)(gen, cfg, lead, device),
    }


def _attn_layers(params, cfg):
    """Each attention layer's params in order, sliced as the loop reaches
    it: the ``first_k_dense`` leading dense blocks
    (``params["dense_blocks"]``), then ``blocks``."""
    k = cfg.first_k_dense
    for i in range(k):
        yield _layer(params["dense_blocks"], i)
    for i in range(cfg.num_layers - k):
        yield _layer(params["blocks"], i)


def _ffn(p, h, cfg, groups):
    if "router" in p:
        return moe_forward(p, h, cfg, groups=groups)
    return mlp_forward(p, h, cfg), None


def _apply_attn_block(p, x, cfg, groups):
    h = apply_norm(p["norm1"], x, cfg)
    x = x + (attn.mla_forward if cfg.use_mla else attn.gqa_forward)(p["attn"], h, cfg)
    y, aux = _ffn(p["ffn"], apply_norm(p["norm2"], x, cfg), cfg, groups)
    return x + y, aux


def _init_mamba_block(gen, cfg, lead, device):
    return {"norm1": init_norm(cfg, cfg.d_model, lead, device),
            "mixer": m2.init_mamba2(gen, cfg, lead, device)}


def _apply_mamba_block(p, x, cfg):
    return x + m2.mamba2_forward(p["mixer"], apply_norm(p["norm1"], x, cfg), cfg)


def _apply_shared_block(p, x, cfg):
    """zamba2-style shared attention + MLP block (one param set, many sites)."""
    h = apply_norm(p["norm1"], x, cfg)
    x = x + attn.gqa_forward(p["attn"], h, cfg)
    return x + mlp_forward(p["ffn"], apply_norm(p["norm2"], x, cfg), cfg)


def _hybrid_flags(cfg):
    return [bool(cfg.attn_every) and i % cfg.attn_every == 0
            for i in range(cfg.num_layers)]


def num_shared_attn_sites(cfg) -> int:
    return sum(_hybrid_flags(cfg))


def _segments(cfg):
    """Static decomposition: [(attn_site_before, start_layer, n_layers), ...]."""
    flags = _hybrid_flags(cfg)
    L = cfg.num_layers
    segs, i = [], 0
    while i < L:
        j = i + 1
        while j < L and not flags[j]:
            j += 1
        segs.append((flags[i], i, j - i))
        i = j
    return segs


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def frontend_dim(cfg) -> int:
    return {"audio_frames": 512, "vision_patches": 1152}.get(cfg.frontend, 0)


def padded_vocab(cfg) -> int:
    """Vocab rounded up to a multiple of 512 (``transformer.padded_vocab``)."""
    if cfg.vocab_size % 512 == 0 or cfg.vocab_size < 512:
        return cfg.vocab_size
    return -(-cfg.vocab_size // 512) * 512


def init_model(gen: torch.Generator, cfg, device=None):
    """Random params from ``gen`` in the reference's tree layout, on the
    card unless ``device`` names another (``device.resolve``)."""
    device = resolve(device)
    dt = torch_dtype(cfg.dtype)
    L = (cfg.num_layers,)
    params = {"embed": dense_init(gen, (padded_vocab(cfg), cfg.d_model), dt,
                                  0.02, device)}
    if cfg.arch_type in ("ssm", "hybrid"):
        params["blocks"] = _init_mamba_block(gen, cfg, L, device)
    elif cfg.first_k_dense:
        k = cfg.first_k_dense
        params["dense_blocks"] = _init_attn_block(gen, cfg, (k,), device, dense=True)
        params["blocks"] = _init_attn_block(gen, cfg, (cfg.num_layers - k,), device)
    else:
        params["blocks"] = _init_attn_block(gen, cfg, L, device)
    if cfg.arch_type == "hybrid":
        params["shared"] = {
            "norm1": init_norm(cfg, cfg.d_model, (), device),
            "attn": attn.init_gqa(gen, cfg, (), device),
            "norm2": init_norm(cfg, cfg.d_model, (), device),
            "ffn": init_mlp(gen, cfg, (), device),
        }
    params["final_norm"] = init_norm(cfg, cfg.d_model, (), device)
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(
            gen, (cfg.d_model, padded_vocab(cfg)), dt, 0.02, device)
    if cfg.frontend != "none":
        fd = frontend_dim(cfg)
        params["frontend_proj"] = dense_init(gen, (fd, cfg.d_model), dt,
                                             default_scale(fd), device)
    return params


# ---------------------------------------------------------------------------
# Forward (train / logits only)
# ---------------------------------------------------------------------------


def _embed(params, tokens, cfg, frontend_embeds):
    """Token embeddings, after the projected frontend embeddings if any."""
    x = params["embed"][tokens]  # [B, T_text, d]
    if cfg.frontend != "none":
        fe = frontend_embeds.to(x.dtype) @ params["frontend_proj"]
        x = torch.cat([fe, x], dim=1)
    return x


def _logits(params, x, cfg):
    x = apply_norm(params["final_norm"], x, cfg)
    head = params["embed"].t() if cfg.tie_embeddings else params["lm_head"]
    logits = x @ head
    Vp = logits.shape[-1]
    if Vp != cfg.vocab_size:
        pad = torch.arange(Vp, device=logits.device) >= cfg.vocab_size
        logits = logits.masked_fill(pad, -1e30)
    return logits


def _remat(cfg, fn):
    """``fn`` checkpointed when ``cfg.remat`` and grad are on: its inputs
    are kept and its body runs again in the backward. The layers draw no
    random numbers, so no RNG state is stashed."""
    if not (cfg.remat and torch.is_grad_enabled()):
        return fn
    return lambda *args: checkpoint(fn, *args, use_reentrant=False,
                                    preserve_rng_state=False)


def forward(params, tokens, cfg, *, frontend_embeds=None, groups=1):
    """tokens [B, T_text] int -> (logits [B, T, Vp], aux_loss scalar)."""
    x = _embed(params, tokens, cfg, frontend_embeds)
    aux = torch.zeros((), device=x.device)
    if cfg.arch_type in ("ssm", "hybrid"):
        mamba = _remat(cfg, lambda p, h: _apply_mamba_block(p, h, cfg))
        shared = _remat(cfg, lambda p, h: _apply_shared_block(p, h, cfg))
        for has_attn, start, ln in _segments(cfg):
            if has_attn:
                x = shared(params["shared"], x)
            for i in range(start, start + ln):
                x = mamba(_layer(params["blocks"], i), x)
    else:
        block = _remat(cfg, lambda p, h: _apply_attn_block(p, h, cfg, groups))
        for lp in _attn_layers(params, cfg):
            x, ai = block(lp, x)
            if ai is not None:
                aux = aux + ai
        if not cfg.dropless:  # DeepSeek-V2 adds each layer's balance loss
            aux = aux / max(cfg.num_layers, 1)
    return _logits(params, x, cfg), aux


# ---------------------------------------------------------------------------
# KV / SSM cache
# ---------------------------------------------------------------------------


def cache_len(cfg, seq_len: int) -> int:
    if cfg.sliding_window:
        return min(seq_len, cfg.sliding_window)
    return seq_len


def init_cache(cfg, batch: int, seq_len: int, dtype=None, device=None):
    """Empty cache sized for a context of ``seq_len`` tokens."""
    device = resolve(device)
    dt = torch_dtype(dtype or cfg.dtype)
    L = cfg.num_layers
    z = lambda *s: torch.zeros(s, dtype=dt, device=device)
    c = {"pos": torch.zeros(batch, dtype=torch.long, device=device)}
    S = cache_len(cfg, seq_len)
    D = cfg.resolved_head_dim
    if cfg.arch_type in ("ssm", "hybrid"):
        d_inner, H, G, N, d_conv = m2.mamba2_dims(cfg)
        c["conv"] = z(L, batch, cfg.ssm_conv_width - 1, d_conv)
        c["state"] = torch.zeros((L, batch, H, cfg.ssm_headdim, N),
                                 dtype=torch.float32, device=device)
        if cfg.arch_type == "hybrid":
            n_attn = num_shared_attn_sites(cfg)
            c["k"] = z(n_attn, batch, S, cfg.num_kv_heads, D)
            c["v"] = z(n_attn, batch, S, cfg.num_kv_heads, D)
    elif cfg.use_mla:
        c["ckv"] = z(L, batch, S, cfg.kv_lora_rank)
        c["krope"] = z(L, batch, S, cfg.qk_rope_head_dim)
    else:
        c["k"] = z(L, batch, S, cfg.num_kv_heads, D)
        c["v"] = z(L, batch, S, cfg.num_kv_heads, D)
    if cfg.arch_type != "ssm":
        c["slot_pos"] = torch.full((batch, S), -1, dtype=torch.long, device=device)
    return c


def _decode_slot(cfg, pos, S):
    if cfg.sliding_window:
        return pos % S
    return pos.clamp_max(S - 1)


# ---------------------------------------------------------------------------
# Decode step (one new token against the cache)
# ---------------------------------------------------------------------------


def decode_step(params, cache, token, cfg, *, groups=1):
    """token [B,1] int -> (logits [B,1,V], cache), the cache updated in
    place (the reference returns a new one)."""
    B = token.shape[0]
    pos = cache["pos"]  # [B] absolute position of this token
    x = params["embed"][token]  # [B,1,d]
    if "slot_pos" in cache:
        S = cache["slot_pos"].shape[1]
        slot = _decode_slot(cfg, pos, S)
        slot_pos = cache["slot_pos"]
        slot_pos[torch.arange(B, device=pos.device), slot] = pos

    if cfg.arch_type in ("ssm", "hybrid"):
        shared = params.get("shared")
        conv, state = cache["conv"], cache["state"]
        ai = 0
        for has_attn, start, ln in _segments(cfg):
            if has_attn:
                hn = apply_norm(shared["norm1"], x, cfg)
                a, _, _ = attn.gqa_decode(shared["attn"], hn, cache["k"][ai],
                                          cache["v"][ai], slot_pos, slot, pos, cfg)
                x = x + a
                x = x + mlp_forward(shared["ffn"],
                                    apply_norm(shared["norm2"], x, cfg), cfg)
                ai += 1
            for i in range(start, start + ln):
                lp = _layer(params["blocks"], i)
                hn = apply_norm(lp["norm1"], x, cfg)
                y, conv[i], state[i] = m2.mamba2_decode(lp["mixer"], hn, conv[i],
                                                        state[i], cfg)
                x = x + y
    else:
        kn = ("ckv", "krope") if cfg.use_mla else ("k", "v")
        for i, lp in enumerate(_attn_layers(params, cfg)):
            hn = apply_norm(lp["norm1"], x, cfg)
            if cfg.use_mla:
                a, _, _ = attn.mla_decode(lp["attn"], hn, cache[kn[0]][i],
                                          cache[kn[1]][i], slot_pos, slot, pos, cfg)
            else:
                a, _, _ = attn.gqa_decode(lp["attn"], hn, cache[kn[0]][i],
                                          cache[kn[1]][i], slot_pos, slot, pos, cfg)
            x = x + a
            y, _ = _ffn(lp["ffn"], apply_norm(lp["norm2"], x, cfg), cfg, groups)
            x = x + y

    cache["pos"] = pos + 1
    return _logits(params, x, cfg), cache


# ---------------------------------------------------------------------------
# Prefill: full-prompt forward that also fills the cache
# ---------------------------------------------------------------------------


def _fill(dst, keep_slots, val):
    """dst[:, slots] = val[:, kept] for the kept positions whose slot lies
    in the cache (dst [B,S,...]; val [B,T,...])."""
    kept, slots = keep_slots
    dst[:, slots] = val[:, kept].to(dst.dtype)


def prefill(params, tokens, cfg, *, frontend_embeds=None, groups=1, max_len=None):
    """tokens [B,T] -> (logits [B,T,V], cache ready for decode at pos=T).

    ``max_len`` sizes the cache (>= T + expected decode steps); defaults to T.
    """
    x = _embed(params, tokens, cfg, frontend_embeds)
    B, T, _ = x.shape
    dev = x.device
    cache = init_cache(cfg, B, max_len or T, device=dev)
    S = cache_len(cfg, max_len or T)
    # positions retained; without a window a slot beyond the cache is
    # dropped, as jax's scatter does (the kept ones are a prefix: a slice,
    # which also keeps the step evaluable on meta tensors)
    lo = max(T - S, 0)
    keep = torch.arange(lo, T if cfg.sliding_window else max(min(T, S), lo),
                        device=dev)
    slots = keep % S if cfg.sliding_window else keep
    keep_slots = (keep, slots)

    if cfg.arch_type in ("ssm", "hybrid"):
        shared = params.get("shared")
        ai = 0
        for has_attn, start, ln in _segments(cfg):
            if has_attn:
                hn = apply_norm(shared["norm1"], x, cfg)
                kk, vv = attn.gqa_fill_cache(shared["attn"], hn, cfg)
                _fill(cache["k"][ai], keep_slots, kk)
                _fill(cache["v"][ai], keep_slots, vv)
                x = _apply_shared_block(shared, x, cfg)
                ai += 1
            for i in range(start, start + ln):
                lp = _layer(params["blocks"], i)
                hn = apply_norm(lp["norm1"], x, cfg)
                y, cache["state"][i], cache["conv"][i] = m2.mamba2_forward(
                    lp["mixer"], hn, cfg, return_state=True)
                x = x + y
    else:
        kn = ("ckv", "krope") if cfg.use_mla else ("k", "v")
        for i, lp in enumerate(_attn_layers(params, cfg)):
            hn = apply_norm(lp["norm1"], x, cfg)
            if cfg.use_mla:
                a = attn.mla_forward(lp["attn"], hn, cfg)
                filled = attn.mla_fill_cache(lp["attn"], hn, cfg)
            else:
                a = attn.gqa_forward(lp["attn"], hn, cfg)
                filled = attn.gqa_fill_cache(lp["attn"], hn, cfg)
            for name, val in zip(kn, filled):
                _fill(cache[name][i], keep_slots, val)
            x = x + a
            y, _ = _ffn(lp["ffn"], apply_norm(lp["norm2"], x, cfg), cfg, groups)
            x = x + y
    if "slot_pos" in cache:
        cache["slot_pos"][:, keep_slots[1]] = keep_slots[0]
    cache["pos"] = torch.full((B,), T, dtype=torch.long, device=dev)
    return _logits(params, x, cfg), cache
