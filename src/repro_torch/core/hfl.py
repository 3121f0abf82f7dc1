"""Hierarchical FL engine, single process (``repro.core.hfl``).

  * ``make_cluster_train_step``: one intra-cluster iteration for each of
    the N clusters (a loop over clusters replaces ``vmap``);
    ``make_masked_cluster_train_step`` the same for one cluster n.
  * ``make_sync``: the every-H inter-cluster consensus (Alg. 5 l.22-39):
    ``dense`` model averaging, or the paper's ``sparse`` whole-vector Ω
    with β-discounted error feedback up and down (``quantized_sparse``
    adds the bf16/q8 wire rounding); the legacy per-leaf layout
    (``sync_layout="leaf"``); in-sync learning-health statistics
    (``collect_stats``); and at depth > 2 the tiered cascade
    (``HierSyncStep``: every tier boundary runs the same protocol with
    its own φ and β, plus the unit scheduler's within-unit syncs and
    staleness-weighted pushes).

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
    buffer (at depth > 2 in each aggregator's own error row, the tier
    buffers ``HierBufs`` updated in place like the state);
  * the train step and the optimizer update params and moments in place.
The arithmetic, and its order, is the reference's as XLA compiles it
(fused multiply-adds and reciprocal multiplies, ``utils/fp.py``), so a
sync from the same state is bitwise equal on the CPU. Callers rebind
``state = sync(state)``; the old tuple's buffers ARE the new ones.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import sparsify as sp
from repro_torch.obs.metrics import current_registry
from repro_torch.utils import flatten as fl
from repro_torch.utils.fp import axpy_, fma_f32, recip_f32
from repro_torch.utils.tree import tree_flatten, tree_leaves, tree_map, tree_unflatten


def _count_build(kind: str, **labels) -> None:
    """Build-time bookkeeping into the ambient metrics registry: which
    step builders ran, under which mode/layout/impl — the builders have no
    telemetry handle to thread, and build time is off the hot path."""
    reg = current_registry()
    if reg.enabled:
        reg.counter(f"hfl.{kind}_builds").inc(**labels)


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
    _count_build("train_step", masked="no")

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
    _count_build("train_step", masked="yes")

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
    half-to-even, like ``jnp.round``). XLA compiles the division by the
    constant 127 into a multiply by the f32 reciprocal, which gives
    another scale for some amax, so the port multiplies too."""
    if fmt == "bf16":
        return x.to(torch.bfloat16).float()
    if fmt == "q8":
        code, scale = _q8_code_scale(x)
        return code * scale
    raise ValueError(fmt)


def _q8_code_scale(x):
    """q8's integer codes and scale, row by row (``_wire_round_rows``)."""
    amax = x.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(amax > 0, amax * recip_f32(127), torch.ones_like(amax))
    return torch.clamp(torch.round(x / scale), -127.0, 127.0), scale


# ---------------------------------------------------------------------------
# Flat-layout sparse sync
# ---------------------------------------------------------------------------


def _f32_buffer(tree, spec, rows=None):
    """The f32 flat buffer behind a flat-backed tree, else a packed copy."""
    base = fl.backing(tree, spec, rows)
    if base is not None and base.dtype == torch.float32:
        return base
    return fl.pack(tree)[0] if rows is None else fl.pack_stacked(tree)[0]


def _drift_(out, child, parent, beta_up: float, spec, eps=None):
    """out <- fma(β_up, eps, child - parent), leaf slice by leaf slice: the
    reference's drift ``child - ref + β·eps`` as XLA compiles it (one fused
    multiply-add, ``utils.fp``). ``child`` is the child's model as one
    1-D slice per leaf (a params row of any dtype, or views of an f32
    row, ``out`` itself included); ``eps`` defaults to ``out``, which is
    how the syncs form the drift inside the child's uplink error row.
    -> out."""
    eps = out if eps is None else eps
    for i, x in enumerate(child):
        sl = spec.leaf_slice(i)
        d = x.float() - parent[sl]
        out[sl] = axpy_(d, beta_up, eps[sl])
    return out


def _row_slices(tree, n: int):
    """Row n of a stacked params tree as one flat slice per leaf."""
    return [P[n].reshape(-1) for P in tree_leaves(tree)]


def _pack_drift(s, params, wref, beta_up: float, spec, rows=None):
    """s [N, Q] holds eps; leave fma(β_s, eps, w_n - w_ref) in it, row by
    row (only ``rows`` when given): the reference's ``_pack_drift``."""
    for n in (range(s.shape[0]) if rows is None else rows):
        _drift_(s[n], _row_slices(params, n), wref, beta_up, spec)


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


def _payload(x, phi: float, impl: str, wire):
    """Ω(x, φ)'s (values, indices), the values wire-rounded: what the
    receiver reconstructs (the sender's residual buffers the rounding)."""
    vals, idx = sp.pack_phi(x, phi, impl=impl)
    if wire:
        vals = _wire_round_rows(vals, wire)
    return vals, idx


def _uplinks_(tc, impl: str, wire, drifts, acc, on_up=None):
    """Each drift row's Ω(φ_up) uplink, in order: Σ sent is added into
    ``acc`` and each row is left holding its residual s - sent.
    ``on_up(values, indices)`` sees every payload as selected."""
    for s in drifts:
        vals, idx = _payload(s, tc.phi_up, impl, wire)
        if on_up is not None:
            on_up(vals, idx)
        _scatter_rows(acc, s[None], idx.long()[None], vals[None])


def _group_(tc, impl: str, wire, drifts, err_row, acc, on_up=None):
    """One aggregator's consensus at one tier boundary (Alg. 5 l.24-31 with
    the tier's φ and β): the children's uplinks (``_uplinks_``, Σ sent in
    ``acc``, zeroed here), then δ = Σ sent / G + β_down·err formed in the
    row ``err_row()`` returns once the uplinks are done. -> the downlink
    Ω(δ, φ_down) (values, indices as selected); the caller applies it."""
    acc.zero_()
    _uplinks_(tc, impl, wire, drifts, acc, on_up)
    err = err_row()
    _consensus_delta(err, acc, tc.fanout, tc.beta_down)
    return _payload(err, tc.phi_down, impl, wire)


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


def flat_sync_payloads(hfl_cfg, params, wref, e, s, spec, on_up=None):
    """The payloads of one flat sync, formed in the buffers given: s [N, Q]
    holds eps and is left with the residuals s_n - sent_n, e holds the MBS
    error and is left with δ. The sync passes its live buffers, the sync
    probe (``comm.accounting``) scratch copies, so both select through the
    same route. ``on_up(values, indices)`` sees each cluster's sent
    payload as selected, in cluster order. -> the downlink (values,
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
        if on_up is not None:
            for v, i in zip(vals, idx):
                on_up(v, i)
        # the reference's _scatter_rows clips pad indices (value 0) to Q-1
        idx = idx.long().clamp_max(Q - 1)
        acc = torch.zeros((Q,), dtype=torch.float32, device=s.device)
        _scatter_rows(acc, s, idx, vals)
        del vals, idx
    else:
        # whole-vector Ω uplinks; Σ sent in Python's left fold
        acc = torch.zeros((Q,), dtype=torch.float32, device=s.device)
        _uplinks_(tier, impl, wire, s, acc, on_up)
    # MBS side: consensus + discounted error + Ω downlink
    _consensus_delta(e, acc, N, tier.beta_down)
    del acc
    if impl != "fused":
        dvals, didx = _payload(e, tier.phi_down, impl, wire)
        return dvals, didx.long()
    dvals, didx = fops.select_topk_rows(e[None, :], sp.keep_count(Q, tier.phi_down))
    dvals, didx = dvals[0], didx[0]
    if wire:
        dvals = _wire_round_rows(dvals, wire)
    return dvals, didx.long()


def _norm(x):
    return torch.linalg.vector_norm(x.float())


# elements per column chunk of the drift statistics: N x 4M entries of
# temporaries at a time, never a whole [N, leaf] copy
_STATS_CHUNK = 1 << 22


def _drift_stats(params):
    """Per-cluster consensus drift ||w_n - w̄|| / ||w̄|| over the stacked
    models (w̄ = Σ w_n · f32(1/N), as XLA compiles the mean), column chunk
    by column chunk: w̄ exists one chunk at a time and the squares add up
    in f64; -> (drift [N], w̄'s norm), f32."""
    leaves = tree_leaves(params)
    N = leaves[0].shape[0]
    r = recip_f32(N)
    sq = torch.zeros((N,), dtype=torch.float64, device=leaves[0].device)
    wsq = torch.zeros((), dtype=torch.float64, device=leaves[0].device)
    for P in leaves:
        X = P.reshape(N, -1)
        for a in range(0, X.shape[1], _STATS_CHUNK):
            x = X[:, a:a + _STATS_CHUNK].float()
            wbar = x.sum(0).mul_(r)
            sq += (x - wbar).double().square().sum(1)
            wsq += wbar.double().square().sum()
    wnorm = wsq.sqrt()
    return (sq.sqrt() / wnorm.clamp_min(1e-30)).float(), wnorm.float()


def _flat_sync_stats(drift, eps, e, wref, dvals, ul_idx, dl_idx):
    """The reference's in-sync learning-health statistics
    (``collect_stats=True``): ``drift`` [N] over the pre-sync models,
    the post-sync residual norms ``eps_norm`` [N] / ``e_norm``, the new
    reference's ``wref_norm``, the applied update's ``update_norm`` and
    the Ω index sets ``ul_idx`` [N, k_ul] / ``dl_idx`` [k_dl]. The state
    is the same with the statistics on or off."""
    return {"drift": drift,
            "eps_norm": torch.stack([_norm(r) for r in eps]),
            "e_norm": _norm(e), "wref_norm": _norm(wref),
            "update_norm": _norm(dvals),  # d's entries are distinct
            "ul_idx": ul_idx, "dl_idx": dl_idx}


def _make_flat_sync(hfl_cfg, collect_stats: bool = False):
    """Whole-vector sync: the payloads of ``flat_sync_payloads`` in the
    state's own buffers, then w_ref += d and e = δ - d. With
    ``collect_stats`` it returns ``(state, stats)``."""
    N = hfl_cfg.num_clusters

    def flat_sync(state: HFLState):
        wref, e, s, ref_spec, eps_spec = _sync_buffers(state, N)
        ul_idx = on_up = drift = None
        if collect_stats:
            drift = _drift_stats(state.params)[0]
            # the uplinks' index sets only (int32: Q < 2^31), row by row
            k = sp.keep_count(ref_spec.total, hfl_cfg.tiers[1].phi_up)
            ul_idx = torch.empty((N, k), dtype=torch.int32, device=s.device)
            rows = iter(ul_idx)
            on_up = lambda v, i: next(rows).copy_(i)
        dvals, didx = flat_sync_payloads(hfl_cfg, state.params, wref, e, s,
                                         ref_spec, on_up=on_up)
        wref.index_add_(0, didx, dvals)  # new w_ref = w_ref + d
        e.index_add_(0, didx, -dvals)    # new e = δ - d
        state = _unpack_ref_outputs(state, wref, e, s, ref_spec, eps_spec)
        if not collect_stats:
            return state
        return state, _flat_sync_stats(drift, s, e, wref, dvals, ul_idx, didx)

    return flat_sync


def _make_dense_sync(hfl_cfg, collect_stats: bool = False):
    N = hfl_cfg.num_clusters

    def dense_sync(state: HFLState):
        if collect_stats:
            drift, wbar_norm = _drift_stats(state.params)
            upd = torch.zeros((), dtype=torch.float64,
                              device=tree_leaves(state.w_ref)[0].device)
        for P, R in zip(tree_leaves(state.params), tree_leaves(state.w_ref)):
            acc = P[0].float().clone()  # jnp.mean: sum * f32(1/N) under XLA
            for n in range(1, N):
                acc.add_(P[n].float())
            mean = acc.mul_(recip_f32(N))
            if collect_stats:
                upd += (mean - R.float()).double().square().sum()
            P.copy_(mean.to(P.dtype).expand_as(P))
            R.copy_(mean.to(R.dtype))
        if not collect_stats:
            return state
        # no Ω and no error feedback: the residual norms are zero and there
        # are no index sets
        dev = drift.device
        return state, {"drift": drift,
                       "eps_norm": torch.zeros((N,), device=dev),
                       "e_norm": torch.zeros((), device=dev),
                       "wref_norm": wbar_norm, "update_norm": upd.sqrt().float()}

    return dense_sync


# ---------------------------------------------------------------------------
# Leaf layout: the legacy per-tensor Ω
# ---------------------------------------------------------------------------


def _make_leaf_sync(hfl_cfg):
    """Single-process per-leaf sync (``repro.core.hfl._make_leaf_local_sync``,
    the legacy reference path): every leaf runs its own exact top-k
    uplinks (k = keep_count of the LEAF's size), consensus and downlink,
    whatever ``omega_impl`` says. Leaf-sized temporaries, dense arithmetic
    in the reference's compiled form; the state is updated in place."""
    wire = wire_format_of(hfl_cfg)
    tier = hfl_cfg.tiers[1]
    N = hfl_cfg.num_clusters

    def one_q8(P, R, Ep, E):
        """A one-element leaf under the q8 wire, as XLA compiles it: the
        one-element scatters fold away and each q8 product code·scale is
        contracted into the add that consumes it (the residuals, the last
        term of Σ sent, the new e and w_ref); δ = fma(β_m, e, Σ·(1/N))."""
        wref = R.reshape(1).float()
        for n in range(N):
            s = axpy_(P[n].reshape(1).float() - wref, tier.beta_up,
                      Ep[n].reshape(1).float())
            code, scale = _q8_code_scale(s)
            Ep[n].copy_(fma_f32(-float(code), scale, s).view(Ep.shape[1:]))
            if n == 0:
                sent = code * scale
            elif n < N - 1:
                sent = sent + code * scale
            else:  # the last term's product is contracted into its add
                sent = fma_f32(float(code), scale, sent)
        delta = fma_f32(tier.beta_down, E.reshape(1).float(), sent * recip_f32(N))
        code, scale = _q8_code_scale(delta)
        new = fma_f32(float(code), scale, wref).view(R.shape)
        E.copy_(fma_f32(-float(code), scale, delta).view(E.shape))
        P.copy_(new.to(P.dtype).expand_as(P))
        R.copy_(new)

    def leaf_sync(state: HFLState):
        for P, R, Ep, E in zip(tree_leaves(state.params), tree_leaves(state.w_ref),
                               tree_leaves(state.eps), tree_leaves(state.e)):
            size = R.numel()
            if size == 1 and wire == "q8":
                one_q8(P, R, Ep, E)
                continue
            wref = R.reshape(-1).float()
            k_ul = sp.keep_count(size, tier.phi_up)
            acc = torch.zeros((size,), dtype=torch.float32, device=wref.device)
            for n in range(N):
                s = axpy_(P[n].reshape(-1).float() - wref, tier.beta_up,
                          Ep[n].reshape(-1).float())
                vals, idx = sp.pack_topk(s, k_ul)
                if wire:
                    vals = _wire_round_rows(vals, wire)
                sent = sp.unpack_topk(vals, idx, size)
                Ep[n].copy_((s - sent).view(Ep.shape[1:]))
                acc.add_(sent)
            delta = E.reshape(-1).float().clone()
            if size == 1:
                # XLA fuses a one-element leaf's mean apart from the add,
                # then contracts the other product: fma(β_m, e, Σ·(1/N))
                delta = fma_f32(tier.beta_down, delta, acc * recip_f32(N))
            else:
                _consensus_delta(delta, acc, N, tier.beta_down)
            dvals, didx = sp.pack_topk(delta, sp.keep_count(size, tier.phi_down))
            if wire:
                dvals = _wire_round_rows(dvals, wire)
            d = sp.unpack_topk(dvals, didx, size)
            new = (wref + d).view(R.shape)
            E.copy_((delta - d).view(E.shape))
            P.copy_(new.to(P.dtype).expand_as(P))
            R.copy_(new)
        return state

    return leaf_sync


# ---------------------------------------------------------------------------
# Depth > 2: the tiered cascade, in place
# ---------------------------------------------------------------------------


class HierBufs(NamedTuple):
    """Flat f32 side buffers of the tiers between the clusters and the root
    (depth T >= 3; ``A_t = HFLConfig.agg_count(t)`` aggregators per tier).

      * ``refs[t-1]``  [A_t, Q]      tier-t reference models, t in 1..T-2
      * ``eps[t-2]``   [A_{t-1}, Q]  tier-t uplink errors,    t in 2..T-1
      * ``errs[t-1]``  [A_t, Q]      tier-t downlink errors,  t in 1..T-2

    Tier 1's uplink error is ``HFLState.eps`` and the root's reference and
    downlink error are ``HFLState.w_ref`` / ``HFLState.e``. The syncs
    update these rows IN PLACE; callers rebind ``state, bufs = ...``.
    """

    refs: tuple
    eps: tuple
    errs: tuple


def init_hier_bufs(state: HFLState, hfl_cfg) -> HierBufs:
    """Zero-error, reference-replicated buffers for ``HierSyncStep``, on the
    state's device."""
    T = len(hfl_cfg.tiers)
    wref = fl.pack(state.w_ref)[0]
    Q = wref.numel()
    zeros = lambda rows: torch.zeros((rows, Q), dtype=torch.float32,
                                     device=wref.device)
    return HierBufs(
        refs=tuple(wref.expand(hfl_cfg.agg_count(t), Q).clone()
                   for t in range(1, T - 1)),
        eps=tuple(zeros(hfl_cfg.agg_count(t - 1)) for t in range(2, T)),
        errs=tuple(zeros(hfl_cfg.agg_count(t)) for t in range(1, T - 1)))


def hier_fire_top(tiers, round_idx: int) -> int:
    """Highest tier firing at (1-based) tier-1 round ``round_idx``: tier 1
    fires every round, tier t >= 2 every ``prod(tiers[2..t].period)``."""
    top, stride = 1, 1
    for t in range(2, len(tiers)):
        stride *= tiers[t].period
        if round_idx % stride == 0:
            top = t
    return top


def _subtree_width(tiers, lo: int, hi: int) -> int:
    """Tier-``lo`` rows under ONE tier-``hi`` aggregator:
    ``prod(fanout of tiers lo+1..hi)`` (1 when ``lo == hi``)."""
    out = 1
    for t in range(lo + 1, hi + 1):
        out *= tiers[t].fanout
    return out


class _Levels:
    """The rows of every level of a (state, bufs) pair: level 0 is the
    clusters' params, level t >= 1 the tier-t references, the root's being
    ``w_ref`` as a [1, Q] view. ``eps[t-1]`` / ``errs[t-1]`` are boundary
    t's uplink / downlink errors (``HFLState.eps`` and ``e`` at the ends),
    so every boundary reads its rows the same way."""

    def __init__(self, state: HFLState, bufs: HierBufs, hfl_cfg):
        self.wref, self.e, eps1, self.spec, self.eps_spec = _sync_buffers(
            state, hfl_cfg.num_clusters)
        self.params = state.params
        self.refs = list(bufs.refs) + [self.wref[None]]
        self.eps = [eps1] + list(bufs.eps)
        self.errs = list(bufs.errs) + [self.e[None]]

    def child(self, t: int, c: int):
        """Child c of boundary t (a level t-1 row) as one slice per leaf."""
        if t == 1:
            return _row_slices(self.params, c)
        row = self.refs[t - 2][c]
        return [row[self.spec.leaf_slice(i)] for i in range(len(self.spec.sizes))]

    def set_row_(self, level: int, r: int, src) -> None:
        """Row r of ``level`` <- the f32 row ``src`` (params: one cast)."""
        if level > 0:
            self.refs[level - 1][r].copy_(src)
            return
        for i, P in enumerate(tree_leaves(self.params)):
            P[r].copy_(src[self.spec.leaf_slice(i)].view(P.shape[1:]))

    def out(self, state: HFLState, root: bool):
        """(state, bufs) viewing the updated rows; w_ref and e only change
        when the root boundary ran."""
        state = state._replace(eps=fl.unpack_stacked(self.eps[0], self.eps_spec))
        if root:
            state = state._replace(w_ref=fl.unpack(self.wref, self.spec),
                                   e=fl.unpack(self.e, self.spec))
        return state, HierBufs(refs=tuple(self.refs[:-1]),
                               eps=tuple(self.eps[1:]),
                               errs=tuple(self.errs[:-1]))


def _adopt_down_(lv: _Levels, tiers, level: int, lo: int, hi: int) -> None:
    """Rows [lo, hi) of ``level`` are adopted by their whole subtrees,
    level by level down to the clusters (Alg. 5 l.33/43 per subtree)."""
    for t in range(level, 0, -1):
        G = tiers[t].fanout
        for c in range(lo * G, hi * G):
            lv.set_row_(t - 1, c, lv.refs[t - 1][c // G])
        lo, hi = lo * G, hi * G


def _cascade_(lv: _Levels, hfl_cfg, wire, top: int, lo: int, hi: int) -> None:
    """Boundaries 1..``top`` of the subtrees under level-``top`` rows
    [lo, hi) sync bottom-up, then those subtrees adopt the new references.

    At boundary t each aggregator a runs ``_group_``: its children's
    drifts, formed in their own uplink-error rows, go up as Ω(φ_up); Σ sent
    accumulates in one [Q] buffer; δ is formed in a's downlink-error row
    and a's reference receives the downlink d (k entries). Nothing of the
    reference's [A·G, Q] ``s``/``sent``/``delta`` stacks is materialized.
    """
    tiers = hfl_cfg.tiers
    impl, spec = hfl_cfg.omega_impl, lv.spec
    acc = torch.empty((spec.total,), dtype=torch.float32, device=lv.wref.device)
    for t in range(1, top + 1):
        tc = tiers[t]
        G, W = tc.fanout, _subtree_width(tiers, t, top)
        for a in range(lo * W, hi * W):
            parent, err = lv.refs[t - 1][a], lv.errs[t - 1][a]
            drifts = (_drift_(lv.eps[t - 1][c], lv.child(t, c), parent,
                              tc.beta_up, spec)
                      for c in range(a * G, (a + 1) * G))
            dvals, didx = _group_(tc, impl, wire, drifts, lambda: err, acc)
            didx = didx.long()
            err.index_add_(0, didx, -dvals)    # e = δ - d
            parent.index_add_(0, didx, dvals)  # ref = ref + d
    del acc
    _adopt_down_(lv, tiers, top, lo, hi)


def _hier_cascade(state: HFLState, bufs: HierBufs, *, hfl_cfg, top: int, wire):
    """One boundary of the tiered consensus: tiers 1..``top`` sync
    bottom-up, then every level below ``top`` adopts its new ancestor
    reference (``repro.core.hfl._hier_cascade``)."""
    T = len(hfl_cfg.tiers)
    assert 1 <= top <= T - 1
    lv = _Levels(state, bufs, hfl_cfg)
    _cascade_(lv, hfl_cfg, wire, top, 0, hfl_cfg.agg_count(top))
    return lv.out(state, root=top == T - 1)


def _hier_unit_sync(state: HFLState, bufs: HierBufs, *, hfl_cfg, cut: int,
                    u: int, utop: int, wire):
    """Within-unit consensus of a mixed-discipline run: boundaries
    1..``utop`` of the subtree under unit ``u`` (one tier-``cut-1``
    aggregator) sync and adopt; every other unit is untouched."""
    tiers = hfl_cfg.tiers
    assert 1 <= utop <= cut - 1 <= len(tiers) - 2
    lv = _Levels(state, bufs, hfl_cfg)
    W = _subtree_width(tiers, utop, cut - 1)
    _cascade_(lv, hfl_cfg, wire, utop, u * W, (u + 1) * W)
    return lv.out(state, root=False)


def _hier_push(state: HFLState, bufs: HierBufs, weight, *, hfl_cfg, t: int,
               a: int, wire):
    """Staleness-weighted async push across boundary ``t``: tier-``t-1``
    aggregator ``a`` (a cluster when ``t == 1``) Ω(φ_up)-pushes its drift,
    the parent reference becomes fma(weight, sent, ref) on the k sent
    entries (``weight`` rounded to f32, as the reference passes it), and
    ``a``'s whole subtree densely adopts the fresh parent."""
    tiers = hfl_cfg.tiers
    tc = tiers[t]
    lv = _Levels(state, bufs, hfl_cfg)
    parent = lv.refs[t - 1][a // tc.fanout]
    s = _drift_(lv.eps[t - 1][a], lv.child(t, a), parent, tc.beta_up, lv.spec)
    vals, idx = _payload(s, tc.phi_up, hfl_cfg.omega_impl, wire)
    up = idx.long()
    parent[up] = fma_f32(float(np.float32(weight)), vals, parent[up])
    s.index_add_(0, up, -vals)  # eps = s - sent
    lv.set_row_(t - 1, a, parent)
    _adopt_down_(lv, tiers, t - 1, a, a + 1)
    return lv.out(state, root=t == len(tiers) - 1)


def hier_payloads(hfl_cfg, state: HFLState, bufs: HierBufs, top: int,
                  on_up: Callable, on_down: Callable) -> None:
    """The payloads the cascade up to ``top`` is about to send, selected by
    the cascade's own ``_group_`` on two scratch rows (the drift or δ row,
    and Σ sent): ``on_up(t, values, indices)`` for every child in row
    order, ``on_down(t, values, indices)`` for every aggregator. Boundary
    t >= 2's children are the new references ref + d, formed in the
    scratch row from the live row and the kept payload d. The state and
    the buffers are left as they were."""
    tiers = hfl_cfg.tiers
    lv = _Levels(state, bufs, hfl_cfg)
    spec, impl, wire = lv.spec, hfl_cfg.omega_impl, wire_format_of(hfl_cfg)
    S, acc = (torch.empty((spec.total,), dtype=torch.float32, device=lv.wref.device)
              for _ in range(2))
    S_slices = [S[spec.leaf_slice(i)] for i in range(len(spec.sizes))]
    downs = []
    for t in range(1, top + 1):
        tc = tiers[t]
        G, below, downs = tc.fanout, downs, []
        for a in range(hfl_cfg.agg_count(t)):
            parent = lv.refs[t - 1][a]

            def drifts():
                for c in range(a * G, (a + 1) * G):
                    if t == 1:
                        child = lv.child(1, c)
                    else:
                        dv, di = below[c]
                        S.copy_(lv.refs[t - 2][c]).index_add_(0, di.long(), dv)
                        child = S_slices
                    yield _drift_(S, child, parent, tc.beta_up, spec,
                                  eps=lv.eps[t - 1][c])

            down = _group_(tc, impl, wire, drifts(),
                           lambda: S.copy_(lv.errs[t - 1][a]), acc,
                           on_up=lambda v, i: on_up(t, v, i))
            on_down(t, *down)
            downs.append(down)


class HierSyncStep:
    """Tiered consensus for depth > 2 (``repro.core.hfl.HierSyncStep``):
    ``(state, bufs, top=None) -> (state, bufs)``, in place on both.

    Build the buffers with :meth:`init_bufs`; ``top`` defaults to a full
    root sync. The simulator detects this object by its ``hier``
    attribute and threads the buffers through the run.
    """

    hier = True
    collect_stats = False

    def __init__(self, hfl_cfg):
        if hfl_cfg.sync_mode not in ("sparse", "quantized_sparse"):
            raise ValueError(
                "depth > 2 hierarchies run the sparse consensus only "
                f"(sync_mode={hfl_cfg.sync_mode!r})")
        if hfl_cfg.omega_impl == "fused":
            raise ValueError(
                "omega_impl='fused' is depth-2 only; use 'topk'/'hist' "
                "for deeper hierarchies")
        if hfl_cfg.omega_impl not in ("topk", "hist", "pallas"):
            raise ValueError(hfl_cfg.omega_impl)
        _count_build("sync_step", mode=hfl_cfg.sync_mode, layout="hier",
                     impl=hfl_cfg.omega_impl)
        self.cfg = hfl_cfg
        self._wire = wire_format_of(hfl_cfg)

    def init_bufs(self, state: HFLState) -> HierBufs:
        return init_hier_bufs(state, self.cfg)

    def fire_top(self, round_idx: int) -> int:
        return hier_fire_top(self.cfg.tiers, round_idx)

    def __call__(self, state: HFLState, bufs: HierBufs, top: int = None):
        if top is None:
            top = len(self.cfg.tiers) - 1
        return _hier_cascade(state, bufs, hfl_cfg=self.cfg, top=int(top),
                             wire=self._wire)

    def unit_ops(self, cut: int):
        """Mixed-discipline helpers for an async top suffix starting at
        boundary ``cut`` -> ``(unit_sync, push)``:
        ``unit_sync(state, bufs, u, utop=cut-1)`` runs boundaries 1..utop
        of unit ``u``'s subtree; ``push(state, bufs, t, a, weight)``
        async-pushes tier-``t-1`` aggregator ``a`` across boundary ``t``."""
        if not 1 <= cut <= len(self.cfg.tiers) - 1:
            raise ValueError(f"cut={cut} out of range for depth "
                             f"{len(self.cfg.tiers)}")

        def unit_sync(state, bufs, u: int, utop: int = None):
            utop = cut - 1 if utop is None else int(utop)
            return _hier_unit_sync(state, bufs, hfl_cfg=self.cfg, cut=cut,
                                   u=int(u), utop=utop, wire=self._wire)

        def push(state, bufs, t: int, a: int, weight: float):
            return _hier_push(state, bufs, weight, hfl_cfg=self.cfg, t=int(t),
                              a=int(a), wire=self._wire)

        return unit_sync, push


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
    """The consensus step of ``plan``, single process: depth 2 dense, flat
    (or fused) and leaf layouts, the flat and dense ones optionally with
    in-sync statistics (``collect_stats``: the sync returns ``(state,
    stats)``); depth > 2 a :class:`HierSyncStep`, with the reference's
    rejections. Mesh syncs and ``flat_shards > 1`` raise, naming the
    ROADMAP item that ports them."""
    hfl_cfg = plan.hfl
    layout = plan.layout or hfl_cfg.sync_layout
    if len(hfl_cfg.tiers) > 2:
        if plan.mesh is not None:
            raise ValueError(
                "depth > 2 hierarchies are single-process only (mesh=None)")
        if plan.collect_stats:
            raise ValueError(
                "collect_stats is not supported on the hierarchical "
                "cascade (depth-2 local flat paths only)")
        if layout != "flat":
            raise ValueError("depth > 2 hierarchies run the flat layout only")
        return HierSyncStep(hfl_cfg)
    if plan.mesh is not None or plan.param_specs is not None:
        raise NotImplementedError("mesh syncs are not ported yet: "
                                  "ROADMAP Queue 1 item 16")
    mode = hfl_cfg.sync_mode
    _count_build("sync_step", mode=mode, layout=layout,
                 impl=hfl_cfg.omega_impl)
    if mode == "dense":
        sync = _make_dense_sync(hfl_cfg, plan.collect_stats)
    elif mode in ("sparse", "quantized_sparse"):
        if layout not in ("flat", "leaf"):
            raise ValueError(layout)
        if layout == "leaf":
            if plan.collect_stats:
                raise ValueError("collect_stats is not supported on the leaf "
                                 "sync path (local flat topk/fused and dense "
                                 "only)")
            sync = _make_leaf_sync(hfl_cfg)
        else:
            if hfl_cfg.flat_shards > 1:
                raise NotImplementedError("flat_shards > 1 is not ported yet: "
                                          "ROADMAP Queue 1 item 16")
            if hfl_cfg.omega_impl not in ("topk", "hist", "pallas", "fused"):
                raise ValueError(hfl_cfg.omega_impl)
            sync = _make_flat_sync(hfl_cfg, plan.collect_stats)
    else:
        raise ValueError(mode)
    sync.collect_stats = plan.collect_stats
    return sync
