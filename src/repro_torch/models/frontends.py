"""Modality frontend stubs ([audio]/[vlm] carve-out): the port of
``repro.models.frontends``.

The modality frontend (mel-spectrogram + conv feature extractor for audio;
the vision encoder + projector for VLMs) is a stub: precomputed frame or
patch embeddings of the right shape, which the decoder consumes through
its learned projector (``params["frontend_proj"]``). The stand-in
embeddings come from a ``torch.Generator``; they are not jax's threefry
numbers, so parity tests carry embeddings across through numpy.
"""
from __future__ import annotations

import torch

from repro_torch.models.transformer import frontend_dim


def frontend_embeds_shape(cfg, batch: int):
    """Shape of the precomputed frontend embeddings (f32)."""
    return (batch, cfg.frontend_tokens, frontend_dim(cfg))


def fake_frontend_embeds(gen: torch.Generator, cfg, batch: int):
    """Deterministic stand-in embeddings, normal x 0.02 in f32, on the
    generator's device. Audio: EnCodec-frame-like embeddings; VLM: the
    flattened anyres patch grid."""
    return torch.randn(frontend_embeds_shape(cfg, batch), generator=gen,
                       device=gen.device, dtype=torch.float32) * 0.02
