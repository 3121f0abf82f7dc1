"""Step builders: the LM loss, the mesh sync and the serve
(prefill/decode) steps, the port of ``repro.launch.steps`` (its dry-run
input specs wait for ROADMAP Queue 1 item 16 part 2)."""
from __future__ import annotations

import torch

from repro_torch.core.hfl import SyncPlan, make_sync
from repro_torch.models.transformer import decode_step, forward, prefill


def cross_entropy(logits, targets):
    """Per-position CE in f32: logsumexp minus the target logit."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    tgt = torch.gather(lf, -1, targets.long()[..., None])[..., 0]
    return lse - tgt


def make_loss_fn(cfg, groups: int = 1):
    """LM loss over a batch dict: ``tokens`` [B, T], the frontend
    embeddings ``frontend`` [B, F, fd] where the architecture has a
    frontend, and an optional ``row_weight`` leaf [B], which scales each
    row's contribution while the normalizer stays the ROW COUNT (not the
    weight sum), as in the reference; weights of 1 equal the plain mean.
    The loss is taken over the text positions only."""

    def loss_fn(params, batch):
        tokens = batch["tokens"]
        rw = batch.get("row_weight")
        logits, aux = forward(params, tokens, cfg,
                              frontend_embeds=batch.get("frontend"), groups=groups)
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


def build_sync_step(hfl_cfg, mesh, pspecs):
    """The consensus step on ``mesh`` with ``pspecs`` (``core.hfl.
    make_sync``): each rank calls it on its rank-local state
    (``core.hfl.rank_state``), which it updates in place."""
    return make_sync(SyncPlan(hfl_cfg, mesh=mesh, param_specs=pspecs))


def build_prefill_step(cfg, groups: int = 1):
    """``prefill_step(params, tokens, frontend=None) -> (logits, cache)``,
    without autograd; the cache is sized to the prompt, as the
    reference's step sizes it."""

    @torch.no_grad()
    def prefill_step(params, tokens, frontend=None):
        return prefill(params, tokens, cfg, frontend_embeds=frontend,
                       groups=groups)

    return prefill_step


def build_decode_step(cfg, groups: int = 1):
    """``serve_step(params, cache, token) -> (logits, cache)``, without
    autograd; the cache is updated in place."""

    @torch.no_grad()
    def serve_step(params, cache, token):
        return decode_step(params, cache, token, cfg, groups=groups)

    return serve_step
