"""LM loss: the port of ``repro.launch.steps.cross_entropy``/``make_loss_fn``."""
from __future__ import annotations

import torch

from repro_torch.models.transformer import forward


def cross_entropy(logits, targets):
    """Per-position CE in f32: logsumexp minus the target logit."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    tgt = torch.gather(lf, -1, targets.long()[..., None])[..., 0]
    return lse - tgt


def make_loss_fn(cfg):
    """LM loss over a batch dict. An optional ``row_weight`` leaf [B]
    scales each row's contribution while the normalizer stays the ROW
    COUNT (not the weight sum), as in the reference; weights of 1 equal
    the plain mean."""

    def loss_fn(params, batch):
        tokens = batch["tokens"]
        rw = batch.get("row_weight")
        logits, aux = forward(params, tokens, cfg)
        T = tokens.shape[1]
        ce = cross_entropy(logits[:, -T:-1], tokens[:, 1:])
        if rw is None:
            loss = ce.mean()
        else:
            loss = (rw * ce.mean(dim=-1)).mean()
        if cfg.num_experts:
            loss = loss + cfg.router_aux_loss_coef * aux
        return loss, aux

    return loss_fn
