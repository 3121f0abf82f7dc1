"""Step builders: the LM loss, the HFL train step, the mesh sync and the
serve (prefill/decode) steps, and the dry-run's input specs for every
(arch x input-shape x mesh) combination: the port of
``repro.launch.steps``.

The input specs are ``launch.sharding.ShapeDtypeStruct`` trees: shapes
evaluated on the ``meta`` device (nothing is allocated), in the
reference's dtypes, each leaf with its spec on the mesh and the block one
rank holds.
"""
from __future__ import annotations

import torch

from repro_torch.core.hfl import (
    HFLState, SyncPlan, hfl_init, make_cluster_train_step, make_sync,
)
from repro_torch.launch import sharding as shp
from repro_torch.launch.mesh import axis_names, axis_size
from repro_torch.launch.sharding import P
from repro_torch.models.transformer import (
    decode_step, forward, frontend_dim, init_cache, init_model, prefill,
)
from repro_torch.optim import SGDM, warmup_step_decay
from repro_torch.utils.tree import tree_map


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------


def cross_entropy(logits, targets):
    """Per-position CE in f32: logsumexp minus the target logit."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    tgt = torch.gather(lf, -1, targets.long()[..., None])[..., 0]
    return lse - tgt


def make_loss_fn(cfg, groups: int = 1, batch_axes=None):
    """LM loss over a batch dict: ``tokens`` [B, T], the frontend
    embeddings ``frontend`` [B, F, fd] where the architecture has a
    frontend, and an optional ``row_weight`` leaf [B], which scales each
    row's contribution while the normalizer stays the ROW COUNT (not the
    weight sum), as in the reference; weights of 1 equal the plain mean.
    The loss is taken over the text positions only. ``batch_axes`` (the
    reference's batch-dim sharding hint) is accepted and unused: the port
    has no partitioner."""

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


# ---------------------------------------------------------------------------
# Train / sync / serve step builders
# ---------------------------------------------------------------------------


def default_optimizer():
    return SGDM(momentum=0.9, weight_decay=1e-4)


def default_schedule():
    return warmup_step_decay(0.25, warmup_steps=1000, decay_steps=(60000, 90000))


def build_train_step(cfg, groups: int = 1, optimizer=None, schedule=None,
                     batch_axes=None):
    """``train_step(state, batch) -> (state, losses [N])``, in place
    (``core.hfl.make_cluster_train_step``) with the default SGDM and
    schedule unless given; ``batch_axes`` as in ``make_loss_fn``."""
    opt = optimizer or default_optimizer()
    sched = schedule or default_schedule()
    return make_cluster_train_step(make_loss_fn(cfg, groups, batch_axes), opt, sched)


def build_sync_step(hfl_cfg, mesh, pspecs):
    """The consensus step on ``mesh`` with ``pspecs`` (``core.hfl.
    make_sync``): each rank calls it on its rank-local state
    (``core.hfl.rank_state``), which it updates in place."""
    return make_sync(SyncPlan(hfl_cfg, mesh=mesh, param_specs=pspecs))


def build_prefill_step(cfg, groups: int = 1, batch_axes=None):
    """``prefill_step(params, tokens, frontend=None) -> (logits, cache)``,
    without autograd; the cache is sized to the prompt, as the
    reference's step sizes it. ``batch_axes`` as in ``make_loss_fn``."""

    @torch.no_grad()
    def prefill_step(params, tokens, frontend=None):
        return prefill(params, tokens, cfg, frontend_embeds=frontend,
                       groups=groups)

    return prefill_step


def build_decode_step(cfg, groups: int = 1, batch_axes=None):
    """``serve_step(params, cache, token) -> (logits, cache)``, without
    autograd; the cache is updated in place. ``batch_axes`` as in
    ``make_loss_fn``."""

    @torch.no_grad()
    def serve_step(params, cache, token):
        return decode_step(params, cache, token, cfg, groups=groups)

    return serve_step


# ---------------------------------------------------------------------------
# Dry-run input specs (shapes on the meta device; no allocation)
# ---------------------------------------------------------------------------


def model_shapes(cfg):
    """The param tree of ``cfg`` as meta tensors (shapes and dtypes only)."""
    return init_model(torch.Generator(), cfg, device="meta")


def train_state_shapes(cfg, hfl_cfg, optimizer=None) -> HFLState:
    """``hfl_init``'s state of ``cfg`` as meta tensors, its ``step`` the
    reference's int32 0-d leaf."""
    state = hfl_init(model_shapes(cfg), optimizer or default_optimizer(), hfl_cfg)
    return state._replace(step=shp.ShapeDtypeStruct((), torch.int32))


def train_input_specs(cfg, shape, mesh, hfl_cfg, optimizer=None):
    """-> (state_sds, batch_sds, pspecs) of ``train_step(state, batch)``."""
    data, model = axis_size(mesh, "data"), axis_size(mesh, "model")
    pod_axis = "pod" if "pod" in axis_names(mesh) else None
    N = hfl_cfg.num_clusters

    p_shapes = model_shapes(cfg)
    pspecs = shp.param_specs(p_shapes, data=data, model=model)
    state_shapes = train_state_shapes(cfg, hfl_cfg, optimizer)

    def lead(spec_tree):
        return tree_map(lambda s: P(pod_axis, *s), spec_tree)

    opt_specs = tree_map(
        lambda l: P(pod_axis, *shp.leaf_spec(tuple(l.shape[1:]), data=data, model=model))
        if l.dim() > 0 else P(),
        state_shapes.opt)
    state_specs = HFLState(params=lead(pspecs), opt=opt_specs, w_ref=pspecs,
                           eps=lead(pspecs), e=pspecs, step=P())
    state_sds = shp.shaped(state_shapes, shp.to_shardings(state_specs, mesh))

    B, T = shape.global_batch, shape.seq_len
    local_B = max(B // N, 1)
    F = cfg.frontend_tokens if cfg.frontend != "none" else 0
    batch = {"tokens": shp.ShapeDtypeStruct((N, local_B, T - F), torch.int32)}
    bspec = {"tokens": P(pod_axis, "data" if local_B % data == 0 else None, None)}
    if F:
        batch["frontend"] = shp.ShapeDtypeStruct((N, local_B, F, frontend_dim(cfg)),
                                                 torch.float32)
        bspec["frontend"] = P(pod_axis, "data" if local_B % data == 0 else None,
                              None, None)
    batch_sds = shp.shaped(batch, shp.to_shardings(bspec, mesh))
    return state_sds, batch_sds, pspecs


def serve_input_specs(cfg, shape, mesh, *, mode: str):
    """mode='decode': (params_sds, cache_sds, token_sds);
    mode='prefill': (params_sds, tokens_sds[, frontend_sds])."""
    data, model = axis_size(mesh, "data"), axis_size(mesh, "model")
    B, S = shape.global_batch, shape.seq_len
    p_shapes = model_shapes(cfg)
    pspecs = shp.param_specs(p_shapes, data=data, model=model)
    params_sds = shp.shaped(p_shapes, shp.to_shardings(pspecs, mesh))

    if mode == "prefill":
        F = cfg.frontend_tokens if cfg.frontend != "none" else 0
        bspec = P("data" if B % data == 0 else None, None)
        out = [params_sds, shp.ShapeDtypeStruct(
            (B, S - F), torch.int32, sharding=shp.NamedSharding(mesh, bspec))]
        if F:
            out.append(shp.ShapeDtypeStruct(
                (B, F, frontend_dim(cfg)), torch.float32,
                sharding=shp.NamedSharding(mesh, P(bspec[0], None, None))))
        return tuple(out)

    cache_shapes = init_cache(cfg, B, S, device="meta")
    cspecs = shp.cache_specs(cache_shapes, data=data, model=model)
    cache_sds = shp.shaped(cache_shapes, shp.to_shardings(cspecs, mesh))
    tok_spec = P("data" if B % data == 0 else None, None)
    token_sds = shp.ShapeDtypeStruct((B, 1), torch.int32,
                                     sharding=shp.NamedSharding(mesh, tok_spec))
    return params_sds, cache_sds, token_sds


def cache_out_shardings(cfg, shape, mesh):
    """The shardings of a produced cache (prefill outputs)."""
    data, model = axis_size(mesh, "data"), axis_size(mesh, "model")
    cache_shapes = init_cache(cfg, shape.global_batch, shape.seq_len, device="meta")
    cspecs = shp.cache_specs(cache_shapes, data=data, model=model)
    return shp.to_shardings(cspecs, mesh)
