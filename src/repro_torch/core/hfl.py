"""Hierarchical FL engine, depth 2, single process (``repro.core.hfl``).

  * ``make_cluster_train_step``: one intra-cluster iteration for each of
    the N clusters (a loop over clusters replaces ``vmap``);
    ``make_masked_cluster_train_step`` the same for one cluster n.
  * ``make_sync``: the every-H inter-cluster consensus (Alg. 5 l.22-39):
    ``dense`` model averaging, or the paper's ``sparse`` whole-vector Ω
    with β-discounted error feedback up and down (``quantized_sparse``
    adds the bf16/q8 wire rounding).

Memory. A full-size model cannot afford the reference's [N, Q] sync
temporaries next to its state, so the port updates the state IN PLACE,
where the reference donates it to XLA:
  * ``hfl_init`` makes ``w_ref``, ``eps`` and ``e`` flat-backed (their
    leaves are views of one f32 buffer, ``utils.flatten``), so the sync
    packs nothing;
  * the drift s = (w_n - w_ref) + β_s·eps is formed inside the eps
    buffer, and the residual s - sent is written there too;
  * the sent rows are never materialized: one [Q] accumulator receives
    them in the reference's left-fold order, and δ is formed in e's
    buffer;
  * the train step and the optimizer update params and moments in place.
The arithmetic, and its order, is the reference's as XLA compiles it
(fused multiply-adds and reciprocal multiplies, ``utils/fp.py``), so a
sync from the same state is bitwise equal on the CPU. Callers rebind
``state = sync(state)``; the old tuple's buffers ARE the new ones.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.core import sparsify as sp
from repro_torch.utils import flatten as fl
from repro_torch.utils.fp import axpy_, recip_f32
from repro_torch.utils.tree import tree_flatten, tree_leaves, tree_map, tree_unflatten


class HFLState(NamedTuple):
    params: Any  # [N, ...] per-cluster models
    opt: Any     # [N, ...] per-cluster optimizer state
    w_ref: Any   # global reference model (no cluster axis)
    eps: Any     # [N, ...] SBS uplink error
    e: Any       # MBS downlink error (global)
    step: int


def hfl_init(params_single, optimizer, hfl_cfg, *, buffer_dtype=torch.float32):
    """HFLState with the single model replicated over N clusters; w_ref,
    eps and e are flat-backed buffers of ``buffer_dtype``."""
    N = hfl_cfg.num_clusters
    rep = tree_map(lambda p: p.unsqueeze(0).repeat((N,) + (1,) * p.dim()),
                   params_single)
    # per-cluster counters (AdamW's t): the reference vmaps init, so a
    # scalar of the single model's state becomes one entry per cluster
    opt = {k: (v.repeat(N) if torch.is_tensor(v) and v.dim() == 0 else v)
           for k, v in optimizer.init(rep).items()}
    spec = fl.spec_of(params_single)
    dev = tree_leaves(params_single)[0].device
    wref_buf, w_ref = fl.flat_backed_zeros(spec, None, buffer_dtype, dev)
    for i, p in enumerate(tree_leaves(params_single)):
        wref_buf[spec.leaf_slice(i)] = p.reshape(-1).to(buffer_dtype)
    _, eps = fl.flat_backed_zeros(spec, N, buffer_dtype, dev)
    _, e = fl.flat_backed_zeros(spec, None, buffer_dtype, dev)
    return HFLState(params=rep, opt=opt, w_ref=w_ref, eps=eps, e=e, step=0)


def serving_params(state: HFLState):
    """Consensus model for serving (cluster 0 post-sync == all clusters)."""
    return tree_map(lambda p: p[0], state.params)


# ---------------------------------------------------------------------------
# Intra-cluster train step
# ---------------------------------------------------------------------------


def _row(tree, n):
    return tree_map(lambda t: t[n] if torch.is_tensor(t) else t, tree)


def _train_row(state: HFLState, n: int, batch_n, loss_fn, optimizer, lr):
    """One iteration of cluster n, in place: its params and optimizer row
    (AdamW's ``t[n]`` included) are updated; -> the loss (detached)."""
    p_n = _row(state.params, n)
    leaves, treedef = tree_flatten(p_n)
    req = [l.detach().requires_grad_(True) for l in leaves]
    with torch.enable_grad():
        loss, _aux = loss_fn(tree_unflatten(treedef, req), batch_n)
        grads = torch.autograd.grad(loss, req, allow_unused=True)
    # unused leaves (the norm placeholders) get zero grads, as in jax
    grads = [torch.zeros_like(r) if g is None else g
             for g, r in zip(grads, req)]
    optimizer.update(tree_unflatten(treedef, grads), _row(state.opt, n), p_n, lr)
    return loss.detach()


def make_cluster_train_step(loss_fn: Callable, optimizer, lr_schedule):
    """loss_fn(params, batch) -> (loss, aux); batch leaves [N, localB, ...].
    Returns ``train_step(state, batch, keep=None) -> (state, losses [N])``;
    params and optimizer state are updated in place, cluster by cluster.

    ``keep`` (bool [N], the simulator's participation): a cluster with
    ``keep[n]`` False sat the round out. Its loss is computed and counted,
    its params and optimizer rows (AdamW's ``t[n]`` too) stay as they were,
    and ``step`` advances: the reference's vmapped step followed by
    ``sim.engine._merge_clusters``.
    """

    def train_step(state: HFLState, batch, keep=None):
        lr = lr_schedule(state.step)
        N = tree_leaves(state.params)[0].shape[0]
        losses = []
        for n in range(N):
            if keep is not None and not keep[n]:
                with torch.no_grad():
                    loss, _aux = loss_fn(_row(state.params, n), _row(batch, n))
                losses.append(loss.detach())
                continue
            losses.append(_train_row(state, n, _row(batch, n), loss_fn,
                                     optimizer, lr))
        return state._replace(step=state.step + 1), torch.stack(losses)

    return train_step


def make_masked_cluster_train_step(loss_fn: Callable, optimizer, lr_schedule):
    """One iteration of ONE cluster (``repro.core.hfl``'s masked step, the
    async disciplines' train step): ``train_step(state, batch_n, n) ->
    (state, loss scalar)`` with ``batch_n`` leaves a single cluster's rows
    ``[localB, ...]``. Row n's params and optimizer state are updated in
    place; every other row stays bitwise as it was; ``step`` advances."""

    def train_step(state: HFLState, batch_n, n: int):
        lr = lr_schedule(state.step)
        loss = _train_row(state, int(n), batch_n, loss_fn, optimizer, lr)
        return state._replace(step=state.step + 1), loss

    return train_step


# ---------------------------------------------------------------------------
# Wire rounding
# ---------------------------------------------------------------------------


def _wire_round_rows(x, fmt: str):
    """What the receiver reconstructs under ``HFLConfig.wire_format``, row
    by row (a 1-D payload is one row): bf16 round-to-nearest-even, or q8
    with scale = max|x|/127 over the LAST axis (``torch.round`` is
    half-to-even, like ``jnp.round``)."""
    if fmt == "bf16":
        return x.to(torch.bfloat16).float()
    if fmt == "q8":
        amax = x.abs().amax(dim=-1, keepdim=True)
        scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
        return torch.clamp(torch.round(x / scale), -127.0, 127.0) * scale
    raise ValueError(fmt)


# ---------------------------------------------------------------------------
# Flat-layout sparse sync
# ---------------------------------------------------------------------------


def _f32_buffer(tree, spec, rows=None):
    """The f32 flat buffer behind a flat-backed tree, else a packed copy."""
    base = fl.backing(tree, spec, rows)
    if base is not None and base.dtype == torch.float32:
        return base
    return fl.pack(tree)[0] if rows is None else fl.pack_stacked(tree)[0]


def _pack_drift(s, params, wref, beta_up: float, spec, rows=None):
    """s [N, Q] holds eps; leave fma(β_s, eps, w_n - w_ref) in it, leaf by
    leaf and row by row (only ``rows`` when given): the reference's
    ``_pack_drift`` as XLA compiles it (one fused multiply-add,
    ``utils.fp``)."""
    for i, P in enumerate(tree_leaves(params)):
        sl = spec.leaf_slice(i)
        for n in (range(P.shape[0]) if rows is None else rows):
            d = P[n].reshape(-1).float() - wref[sl]
            s[n, sl] = axpy_(d, beta_up, s[n, sl])


def _scatter_rows(acc, s, idx, vals):
    """Row n of (idx, vals) is cluster n's sent payload: add it into the
    Σ sent accumulator (rows in order, the reference's left fold) and
    subtract it from the residual s[n], leaving s_n - sent_n there."""
    for n in range(idx.shape[0]):
        acc.index_add_(0, idx[n], vals[n])
        s[n].index_add_(0, idx[n], -vals[n])


def _consensus_delta(e, acc, N: int, beta_down: float):
    """δ = Σ sent_n / N + β_m·e, formed in e's buffer. XLA turns the
    division into a multiply by the f32 reciprocal and fuses it with the
    add: δ = fma(Σ sent_n, 1/N, β_m·e)."""
    e.mul_(beta_down)
    axpy_(e, recip_f32(N), acc)


def _sync_buffers(state: HFLState, N: int):
    """(w_ref, e, eps) as f32 flat buffers, with their specs."""
    ref_spec = fl.spec_of(state.w_ref)
    eps_spec = fl.spec_of_stacked(state.eps)
    return (_f32_buffer(state.w_ref, ref_spec), _f32_buffer(state.e, ref_spec),
            _f32_buffer(state.eps, eps_spec, rows=N), ref_spec, eps_spec)


def _unpack_ref_outputs(state: HFLState, wref, e, s, ref_spec, eps_spec):
    """Clusters adopt the new reference (each leaf cast f32 -> its dtype);
    w_ref/e/eps become views of the buffers again (copies cast to their
    storage dtype where that is not f32)."""
    for i, P in enumerate(tree_leaves(state.params)):
        w = wref[ref_spec.leaf_slice(i)].reshape(ref_spec.shapes[i])
        P.copy_(w.to(P.dtype).expand_as(P))
    return state._replace(w_ref=fl.unpack(wref, ref_spec), e=fl.unpack(e, ref_spec),
                          eps=fl.unpack_stacked(s, eps_spec))


def flat_sync_payloads(hfl_cfg, params, wref, e, s, spec, uplinks=None):
    """The payloads of one flat sync, formed in the buffers given: s [N, Q]
    holds eps and is left with the residuals s_n - sent_n, e holds the MBS
    error and is left with δ. The sync passes its live buffers, the sync
    probe (``comm.accounting``) scratch copies, so both select through the
    same route. Each cluster's sent payload (values, indices as selected)
    is appended to ``uplinks`` when given. -> the downlink (values,
    indices int64)."""
    impl = hfl_cfg.omega_impl
    wire = wire_format_of(hfl_cfg)
    tier = hfl_cfg.tiers[1]
    N, Q = s.shape
    _pack_drift(s, params, wref, tier.beta_up, spec)
    if impl == "fused":
        from repro_torch.kernels.fused_sync import ops as fops

        # the N uplink Ωs are one select_topk_rows call; Σ sent is allocated
        # after it, outside the selection's peak
        vals, idx = fops.select_topk_rows(s, sp.keep_count(Q, tier.phi_up))
        if wire:
            vals = _wire_round_rows(vals, wire)
        if uplinks is not None:
            uplinks.extend(zip(vals, idx))
        # the reference's _scatter_rows clips pad indices (value 0) to Q-1
        idx = idx.long().clamp_max(Q - 1)
        acc = torch.zeros((Q,), dtype=torch.float32, device=s.device)
        _scatter_rows(acc, s, idx, vals)
        del vals, idx
    else:
        # whole-vector Ω uplinks; Σ sent in Python's left fold
        acc = torch.zeros((Q,), dtype=torch.float32, device=s.device)
        for n in range(N):
            vals, idx = sp.pack_phi(s[n], tier.phi_up, impl=impl)
            if wire:
                vals = _wire_round_rows(vals, wire)
            if uplinks is not None:
                uplinks.append((vals, idx))
            _scatter_rows(acc, s[n:n + 1], idx.long()[None], vals[None])
    # MBS side: consensus + discounted error + Ω downlink
    _consensus_delta(e, acc, N, tier.beta_down)
    del acc
    if impl == "fused":
        dvals, didx = fops.select_topk_rows(e[None, :], sp.keep_count(Q, tier.phi_down))
        dvals, didx = dvals[0], didx[0]
    else:
        dvals, didx = sp.pack_phi(e, tier.phi_down, impl=impl)
    if wire:
        dvals = _wire_round_rows(dvals, wire)
    return dvals, didx.long()


def _make_flat_sync(hfl_cfg):
    """Whole-vector sync: the payloads of ``flat_sync_payloads`` in the
    state's own buffers, then w_ref += d and e = δ - d."""
    N = hfl_cfg.num_clusters

    def flat_sync(state: HFLState):
        wref, e, s, ref_spec, eps_spec = _sync_buffers(state, N)
        dvals, didx = flat_sync_payloads(hfl_cfg, state.params, wref, e, s, ref_spec)
        wref.index_add_(0, didx, dvals)  # new w_ref = w_ref + d
        e.index_add_(0, didx, -dvals)    # new e = δ - d
        return _unpack_ref_outputs(state, wref, e, s, ref_spec, eps_spec)

    return flat_sync


def _make_dense_sync(hfl_cfg):
    N = hfl_cfg.num_clusters

    def dense_sync(state: HFLState):
        for P, R in zip(tree_leaves(state.params), tree_leaves(state.w_ref)):
            acc = P[0].float().clone()  # jnp.mean: sum * f32(1/N) under XLA
            for n in range(1, N):
                acc.add_(P[n].float())
            mean = acc.mul_(recip_f32(N))
            P.copy_(mean.to(P.dtype).expand_as(P))
            R.copy_(mean.to(R.dtype))
        return state

    return dense_sync


# ---------------------------------------------------------------------------
# Builder
# ---------------------------------------------------------------------------


def wire_format_of(hfl_cfg) -> Optional[str]:
    if hfl_cfg.sync_mode != "quantized_sparse":
        return None
    return hfl_cfg.wire_format


@dataclass(frozen=True)
class SyncPlan:
    """Resolved spec of one consensus step build (see ``repro.core.hfl``)."""

    hfl: Any
    mesh: Any = None
    param_specs: Any = None
    layout: Optional[str] = None
    collect_stats: bool = False


def make_sync(plan: SyncPlan):
    """The consensus step of ``plan``: depth 2, single process, flat layout
    (or dense). Other plans raise, naming the ROADMAP item that ports them."""
    hfl_cfg = plan.hfl
    if len(hfl_cfg.tiers) > 2:
        raise NotImplementedError("depth > 2 hierarchies (HierSyncStep) are "
                                  "not ported yet: ROADMAP Queue 1 item 13")
    if plan.collect_stats:
        raise NotImplementedError("collect_stats is not ported yet: "
                                  "ROADMAP Queue 1 item 13")
    if plan.mesh is not None or plan.param_specs is not None:
        raise NotImplementedError("mesh syncs are not ported yet: "
                                  "ROADMAP Queue 1 item 16")
    mode = hfl_cfg.sync_mode
    if mode == "dense":
        sync = _make_dense_sync(hfl_cfg)
    elif mode in ("sparse", "quantized_sparse"):
        layout = plan.layout or hfl_cfg.sync_layout
        if layout == "leaf":
            raise NotImplementedError("the leaf sync layout is not ported "
                                      "yet: ROADMAP Queue 1 item 13")
        if layout != "flat":
            raise ValueError(layout)
        if hfl_cfg.flat_shards > 1:
            raise NotImplementedError("flat_shards > 1 is not ported yet: "
                                      "ROADMAP Queue 1 item 16")
        if hfl_cfg.omega_impl not in ("topk", "hist", "pallas", "fused"):
            raise ValueError(hfl_cfg.omega_impl)
        sync = _make_flat_sync(hfl_cfg)
    else:
        raise ValueError(mode)
    sync.collect_stats = False
    return sync
