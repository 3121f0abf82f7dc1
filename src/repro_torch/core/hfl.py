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

import warnings
from dataclasses import dataclass
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import sparsify as sp
from repro_torch.obs.metrics import current_registry
from repro_torch.obs.spans import span
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
    eps and e are flat-backed buffers of ``buffer_dtype`` (with
    ``hfl_cfg.flat_shards`` > 1 of the padded length)."""
    N = hfl_cfg.num_clusters
    rep = tree_map(lambda p: p.unsqueeze(0).repeat((N,) + (1,) * p.dim()),
                   params_single)
    # per-cluster counters (AdamW's t): the reference vmaps init, so a
    # scalar of the single model's state becomes one entry per cluster
    opt = {k: (v.repeat(N) if torch.is_tensor(v) and v.dim() == 0 else v)
           for k, v in optimizer.init(rep).items()}
    # padded to whole shards when the flat vector is sharded, so the
    # sharded sync finds and updates these buffers in place too
    spec = fl.spec_of(params_single, shards=getattr(hfl_cfg, "flat_shards", 1))
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
        with span("hfl.train.forward", state.step):
            loss, _aux = loss_fn(tree_unflatten(treedef, req), batch_n)
        # under remat this includes the forward's recompute
        with span("hfl.train.backward", state.step):
            grads = torch.autograd.grad(loss, req, allow_unused=True)
    # unused leaves (the norm placeholders) get zero grads, as in jax
    grads = [torch.zeros_like(r) if g is None else g
             for g, r in zip(grads, req)]
    with span("hfl.train.optimizer", state.step):
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
        with span("hfl.train_step", state.step):
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
    """The f32 flat buffer behind a flat-backed tree, else a packed copy
    (padded as ``spec``)."""
    base = fl.backing(tree, spec, rows)
    if base is not None and base.dtype == torch.float32:
        return base
    if rows is None:
        return fl.pack(tree, shards=spec.shards)[0]
    return fl.pack_stacked(tree, shards=spec.shards)[0]


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
        with span("hfl.sync.select_up"):
            vals, idx = _payload(s, tc.phi_up, impl, wire)
        if on_up is not None:
            on_up(vals, idx)
        with span("hfl.sync.scatter"):
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


def _sync_buffers(state: HFLState, N: int, shards: int = 1):
    """(w_ref, e, eps) as f32 flat buffers, with their specs (``shards``:
    the padded layout)."""
    ref_spec = fl.spec_of(state.w_ref, shards=shards)
    eps_spec = fl.spec_of_stacked(state.eps, shards=shards)
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
    with span("hfl.sync.drift"):
        _pack_drift(s, params, wref, tier.beta_up, spec)
    if impl == "fused":
        from repro_torch.kernels.fused_sync import ops as fops

        # the N uplink Ωs are one select_topk_rows call; Σ sent is allocated
        # after it, outside the selection's peak
        with span("hfl.sync.select_up"):
            vals, idx = fops.select_topk_rows(s, sp.keep_count(Q, tier.phi_up))
            if wire:
                vals = _wire_round_rows(vals, wire)
        if on_up is not None:
            for v, i in zip(vals, idx):
                on_up(v, i)
        with span("hfl.sync.scatter"):
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
    with span("hfl.sync.delta"):
        _consensus_delta(e, acc, N, tier.beta_down)
        del acc
    with span("hfl.sync.select_down"):
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
        with span("hfl.sync", state.step):
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
            with span("hfl.sync.adopt"):
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
# Sharded flat layout: the padded flat vector in contiguous pieces
# ---------------------------------------------------------------------------


class FlatShard(NamedTuple):
    """A piece of the padded flat state: what the reference's sharded
    ``shard_map`` hands one device, and the state the mesh-sharded sync
    updates in place. w_ref, eps and e are f32; ``params`` is of the
    model's dtype when all its leaves share one (clusters adopt w_ref cast
    to it), else f32 holding each entry as a value of its leaf's dtype.
    ``spec`` is the whole model's padded FlatSpec of the params;
    ``shard`` is the piece's index, None for the whole padded vector (what
    the single-process sharded sync takes)."""

    params: torch.Tensor  # [N, L]
    w_ref: torch.Tensor   # [L]
    eps: torch.Tensor     # [N, L]
    e: torch.Tensor       # [L]
    spec: Any
    shard: Optional[int] = None

    @property
    def offset(self) -> int:
        return 0 if self.shard is None else self.shard * self.spec.local_size


def _piece_drift_(fs: FlatShard, beta_up: float) -> None:
    """eps <- fma(β_s, eps, params - w_ref), row by row (``_pack_drift`` on
    a piece)."""
    for n in range(fs.eps.shape[0]):
        fs.eps[n].copy_(axpy_(fs.params[n].float() - fs.w_ref, beta_up, fs.eps[n]))


def flat_params_dtype(spec):
    """The dtype of a ``FlatShard``'s params: the leaves' common dtype, or
    f32 when they differ."""
    return spec.dtypes[0] if len(set(spec.dtypes)) == 1 else torch.float32


def round_to_leaf_dtypes_(x, spec, off: int = 0):
    """Each entry of the f32 rows ``x`` [..., L] (positions [off, off + L)
    of the flat layout ``spec``) rounded to its leaf's dtype, in place;
    -> x."""
    L = x.shape[-1]
    for i, dt in enumerate(spec.dtypes):
        lo = max(off, spec.offsets[i])
        hi = min(off + L, spec.offsets[i] + spec.sizes[i])
        if lo < hi and dt != torch.float32:
            x[..., lo - off:hi - off] = x[..., lo - off:hi - off].to(dt).float()
    return x


def _adopt_piece_(fs: FlatShard) -> None:
    """Every row of params <- w_ref cast to its entry's leaf dtype."""
    fs.params.copy_(fs.w_ref.expand_as(fs.params))
    if fs.params.dtype == torch.float32:  # else the copy cast it already
        round_to_leaf_dtypes_(fs.params, fs.spec, fs.offset)


def _local(idx, vals, off: int, L: int):
    """The entries of a global (indices, values) row that fall in this
    piece [off, off + L), at local int64 positions: pads and other pieces'
    entries add nothing (the reference adds 0.0 for them)."""
    loc = idx.long() - off
    keep = (loc >= 0) & (loc < L)
    return loc[keep], vals[keep]


def _sharded_select(X, k: int, spec, gather=None, off: int = 0):
    """Stage 1 of every shard, then the merge: the reference's
    ``_sharded_select`` -> (vals [R, k], GLOBAL idx [R, k], exact [R]).

    Without ``gather``, ``X`` [R, padded_total] holds every piece and each
    shard's stage 1 runs here (the single-process emulation); with it,
    ``X`` [R, L] is this rank's piece at ``off`` and ``gather(t)`` stacks
    every rank's stage-1 outputs shard-major [S, ...]. Either way the
    merge sees the same candidates in the same order, so the mesh and the
    emulation are bit-identical. The pad index is ``padded_total``. Rows
    go one at a time, so one row's candidates of every shard are alive at
    once."""
    from repro_torch.kernels.fused_sync import ops as fops

    S, L, Qp = spec.shards, spec.local_size, spec.padded_total

    def stage1(piece, at: int):
        v, i, m, th = fops.shard_select_candidates(piece, k, S)
        return v, torch.where(i < L, i + at, torch.full_like(i, Qp)), m, th

    outs = []
    for r in range(X.shape[0]):
        if gather is None:
            parts = [stage1(X[r:r + 1, sh * L:(sh + 1) * L], sh * L)
                     for sh in range(S)]
            cv, ci, m, th = (torch.cat([p[j].reshape(1, -1) for p in parts], dim=1)
                             for j in range(4))
            del parts
        else:  # [S, 1, ...] shard-major: its rows are one contiguous row
            cv, ci, m, th = (gather(t).reshape(1, -1)
                             for t in stage1(X[r:r + 1], off))
        outs.append(fops.merge_shard_candidates(cv, ci, m, th, k))
        del cv, ci
    return tuple(torch.cat([o[j] for o in outs]) for j in range(3))


def _sharded_payloads_(hfl_cfg, s, wref, e, spec, select, off: int, certs):
    """One sharded sync on a piece [off, off + L) in place: s [N, L] holds
    the drift and is left with the residuals, e is left with the new
    downlink error and w_ref with w_ref + d. ``select(X, k)`` is the
    sharded Ω (global indices); each hop's exactness certificates are
    appended to ``certs`` (advisory, as in the reference: an overflowing
    shard's merged union top-k is used as it is)."""
    tier = hfl_cfg.tiers[1]
    wire = wire_format_of(hfl_cfg)
    N, L = s.shape
    vals, idx, exact = select(s, sp.keep_count(spec.total, tier.phi_up))
    certs.append(exact)
    if wire:
        vals = _wire_round_rows(vals, wire)
    acc = torch.zeros((L,), dtype=torch.float32, device=s.device)
    for n in range(N):  # Σ sent in cluster order; s_n - sent_n in s
        loc, v = _local(idx[n], vals[n], off, L)
        acc.index_add_(0, loc, v)
        s[n].index_add_(0, loc, -v)
    del vals, idx
    _consensus_delta(e, acc, N, tier.beta_down)
    del acc
    dvals, didx, exact = select(e[None, :], sp.keep_count(spec.total, tier.phi_down))
    certs.append(exact)
    dvals = dvals[0]
    if wire:
        dvals = _wire_round_rows(dvals, wire)
    loc, v = _local(didx[0], dvals, off, L)
    wref.index_add_(0, loc, v)   # new w_ref = w_ref + d
    e.index_add_(0, loc, -v)     # new e = δ - d


def _certified(certs) -> dict:
    """{"ul": [bool per cluster], "dl": bool} of one sync's certificates."""
    return {"ul": [bool(x) for x in certs[0]], "dl": bool(certs[1][0])}


def _make_flat_sharded_sync(hfl_cfg, shards: int):
    """Single-process sharded flat sync (``repro.core.hfl.
    _make_flat_sharded_local_sync``): the padded flat vector as ``shards``
    contiguous pieces, stage-1 selection per piece, the merge finishing
    the whole-vector Ω; in place on the state's buffers. It takes an
    HFLState, or a whole-vector ``FlatShard``. ``sync.certificates`` holds
    the last call's exactness certificates."""
    N, S = hfl_cfg.num_clusters, shards
    beta_up = hfl_cfg.tiers[1].beta_up

    def sharded_sync(state):
        certs = []
        if isinstance(state, FlatShard):
            if state.shard is not None or state.spec.shards != S:
                raise ValueError("the single-process sharded sync takes the "
                                 f"whole padded vector of a {S}-shard spec")
            _piece_drift_(state, beta_up)
            select = lambda X, k: _sharded_select(X, k, state.spec)
            _sharded_payloads_(hfl_cfg, state.eps, state.w_ref, state.e,
                               state.spec, select, 0, certs)
            _adopt_piece_(state)
        else:
            wref, e, s, ref_spec, eps_spec = _sync_buffers(state, N, shards=S)
            _pack_drift(s, state.params, wref, beta_up, ref_spec)
            select = lambda X, k: _sharded_select(X, k, ref_spec)
            _sharded_payloads_(hfl_cfg, s, wref, e, ref_spec, select, 0, certs)
            state = _unpack_ref_outputs(state, wref, e, s, ref_spec, eps_spec)
        sharded_sync.certificates = _certified(certs)
        return state

    sharded_sync.certificates = None
    return sharded_sync


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
# Mesh syncs over torch.distributed
# ---------------------------------------------------------------------------


def _in_pod_axes(shape: dict) -> tuple:
    return tuple(a for a in ("data", "model") if shape.get(a, 1) > 1)


def mesh_route(plan, shape: dict) -> str:
    """The sync ``plan`` builds on a mesh of ``shape`` ({axis: size}), as
    the reference routes it: "pod" (a "pod" axis: each rank exchanges its
    blocks' payloads with its pod peers), "sharded" (fused Ω, flat layout,
    a pod-less mesh whose ("data", "model") extent is > 1: the flat vector
    shards over those axes) or "local" (every rank runs the single-process
    sync on the whole state, which is what the reference computes there)."""
    hfl_cfg = plan.hfl
    if "pod" in shape:
        return "pod"
    layout = plan.layout or hfl_cfg.sync_layout
    if (hfl_cfg.sync_mode != "dense" and layout == "flat"
            and hfl_cfg.omega_impl == "fused"
            and int(np.prod([shape[a] for a in _in_pod_axes(shape)])) > 1):
        return "sharded"
    return "local"


def _pod_specs(plan, state_tree):
    """Per-leaf specs of the pod route: ``param_specs``, or every leaf
    replicated over ("data", "model") where the plan has none (dense)."""
    from repro_torch.launch.sharding import P

    if plan.param_specs is not None:
        return tree_leaves(plan.param_specs)
    return [P() for _ in tree_leaves(state_tree)]


def rank_state(state: HFLState, plan, shape: dict, coord: dict):
    """The rank-local state of the mesh sync ``plan`` builds, for the rank
    at ``coord`` ({axis: index}) of a mesh of ``shape``, cut from the whole
    ``state`` (copies): what the reference's ``shard_map`` hands that
    device. "pod": an HFLState of blocks under ``param_specs``, params and
    eps ``[C, *loc]`` with the pod axis on the clusters, w_ref and e
    ``[*loc]`` (opt is not part of it); "sharded": the rank's
    ``FlatShard`` (f32 buffers only); "local": ``state`` itself."""
    from repro_torch.launch.sharding import P, rank_block

    route = mesh_route(plan, shape)
    if route == "local":
        return state
    if route == "sharded":
        axes = _in_pod_axes(shape)
        S = int(np.prod([shape[a] for a in axes]))
        sh = 0
        for a in axes:
            sh = sh * shape[a] + coord[a]
        for t in (state.w_ref, state.eps, state.e):
            if any(l.dtype != torch.float32 for l in tree_leaves(t)):
                raise ValueError("the sharded mesh sync keeps f32 buffers")
        spec = fl.spec_of_stacked(state.params, shards=S)
        sl = spec.shard_slice(sh)
        piece = lambda x: x[..., sl].clone()
        return FlatShard(
            params=piece(fl.pack_stacked(state.params, shards=S,
                                         dtype=flat_params_dtype(spec))[0]),
            w_ref=piece(fl.pack(state.w_ref, shards=S)[0]),
            eps=piece(fl.pack_stacked(state.eps, shards=S)[0]),
            e=piece(fl.pack(state.e, shards=S)[0]), spec=spec, shard=sh)
    specs = _pod_specs(plan, state.w_ref)
    cut = lambda tree, lead: tree_unflatten(tree_flatten(tree)[1], [
        rank_block(x, P(*lead, *sp_), shape, coord)
        for x, sp_ in zip(tree_leaves(tree), specs)])
    return state._replace(params=cut(state.params, ("pod",)),
                          w_ref=cut(state.w_ref, ()), eps=cut(state.eps, ("pod",)),
                          e=cut(state.e, ()), opt=None)


def _spec_axes(spec) -> set:
    return {a for e in spec if e is not None
            for a in ((e,) if isinstance(e, str) else e)}


def merge_rank_states(state: HFLState, plan, shape: dict, pieces) -> HFLState:
    """The whole state again from every rank's ``(coord, rank state)``
    (``rank_state``'s inverse); ``state`` gives the trees, dtypes, opt and
    step. A block that several ranks hold (its leaf is replicated over an
    axis) is taken from the rank at index 0 of that axis, as jax assembles
    a ``shard_map`` output: on the pod flat layout the replicas differ,
    since each rank's Ω runs over its whole local vector."""
    from repro_torch.launch.sharding import P, place_block

    route = mesh_route(plan, shape)
    if route == "local":
        return pieces[0][1]
    if route == "sharded":
        order = sorted(pieces, key=lambda cp: cp[1].shard)
        cat = lambda f: torch.cat([getattr(p, f) for _, p in order], dim=-1)
        S = order[0][1].spec.shards
        return state._replace(
            params=fl.unpack_stacked(cat("params"), fl.spec_of_stacked(state.params, shards=S)),
            w_ref=fl.unpack(cat("w_ref"), fl.spec_of(state.w_ref, shards=S)),
            eps=fl.unpack_stacked(cat("eps"), fl.spec_of_stacked(state.eps, shards=S)),
            e=fl.unpack(cat("e"), fl.spec_of(state.e, shards=S)))
    specs = _pod_specs(plan, state.w_ref)

    def put(field, lead):
        leaves, treedef = tree_flatten(getattr(state, field))
        out = [torch.empty_like(x) for x in leaves]
        for coord, p in pieces:
            for o, b, sp_ in zip(out, tree_leaves(getattr(p, field)), specs):
                spec = P(*lead, *sp_)
                if any(coord[a] for a in shape if a not in _spec_axes(spec)):
                    continue  # a replica: jax keeps the one at index 0
                place_block(o, b, spec, shape, coord)
        return tree_unflatten(treedef, out)

    return state._replace(params=put("params", ("pod",)), w_ref=put("w_ref", ()),
                          eps=put("eps", ("pod",)), e=put("e", ()))


def _make_mesh_sharded_sync(hfl_cfg, mesh):
    """The flat vector sharded over the in-pod ("data", "model") axes
    (``repro.core.hfl._make_flat_sharded_sync``): each rank holds one
    contiguous piece (a ``FlatShard``), runs the per-shard compaction on
    it and gathers only the compacted candidates of every shard; the
    merge is the same replicated math on every rank, and each rank applies
    the entries of its own piece. In place; ``sync.certificates`` as the
    single-process sync's."""
    from repro_torch.launch import mesh as M

    axes = _in_pod_axes(M.mesh_shape(mesh))
    S = int(np.prod([M.axis_size(mesh, a) for a in axes]))
    beta_up = hfl_cfg.tiers[1].beta_up
    gather = lambda t: M.gather_shard_major(t, mesh, axes)

    def sharded_sync(fs: FlatShard):
        if fs.spec.shards != S or fs.shard != M.shard_index(mesh, axes):
            raise ValueError(f"this rank holds shard {M.shard_index(mesh, axes)} "
                             f"of {S}; got shard {fs.shard} of {fs.spec.shards}")
        certs = []
        _piece_drift_(fs, beta_up)
        select = lambda X, k: _sharded_select(X, k, fs.spec, gather, fs.offset)
        _sharded_payloads_(hfl_cfg, fs.eps, fs.w_ref, fs.e, fs.spec, select,
                           fs.offset, certs)
        _adopt_piece_(fs)
        sharded_sync.certificates = _certified(certs)
        return fs

    sharded_sync.certificates = None
    return sharded_sync


def _gather_pod(vals, idx, mesh, wire):
    """Every pod's (values, indices) payload rows, pod-major and flat: 2·C·k
    entries each. Under the bf16 wire the values travel as bf16 (lossless:
    they are already rounded)."""
    from repro_torch.launch import mesh as M

    if wire == "bf16":
        vals = vals.to(torch.bfloat16)
    all_v = M.all_gather(vals, mesh, "pod").float().reshape(-1)
    return all_v, M.all_gather(idx, mesh, "pod").reshape(-1).long()


def _write_back_(state: HFLState, wref, e, s, spec) -> None:
    """Each leaf of the rank's blocks <- its slice of the f32 results (the
    clusters adopt w_ref, cast to their dtype)."""
    for i, (P, R, Ep, E) in enumerate(zip(
            tree_leaves(state.params), tree_leaves(state.w_ref),
            tree_leaves(state.eps), tree_leaves(state.e))):
        sl = spec.leaf_slice(i)
        w = wref[sl].view(R.shape)
        P.copy_(w.to(P.dtype).expand_as(P))
        R.copy_(w)
        Ep.copy_(s[:, sl].view(Ep.shape))
        E.copy_(e[sl].view(E.shape))


def _make_pod_flat_sync(hfl_cfg, mesh):
    """``repro.core.hfl._flat_shard_sync`` on each rank: its blocks packed
    into one local flat vector (the layout is the same on every pod peer,
    so a local index names the same entry there), one Ω per hosted cluster
    with ``omega_impl``, one "pod" all-gather of the payloads, the
    scatter-add consensus, one Ω downlink; in place on the blocks."""
    tier, N = hfl_cfg.tiers[1], hfl_cfg.num_clusters
    impl, wire = hfl_cfg.omega_impl, wire_format_of(hfl_cfg)

    def pod_flat_sync(state: HFLState):
        wref, ref_spec = fl.pack(state.w_ref)
        e = fl.pack(state.e)[0]
        s = fl.pack_stacked(state.eps)[0]
        _pack_drift(s, state.params, wref, tier.beta_up, ref_spec)
        sent = []
        for c in range(s.shape[0]):  # C = N / pods clusters on this rank
            v, i = _payload(s[c], tier.phi_up, impl, wire)
            s[c].index_add_(0, i.long(), -v)  # eps = s - sent
            sent.append((v, i))
        all_v, all_i = _gather_pod(torch.stack([v for v, _ in sent]),
                                   torch.stack([i for _, i in sent]), mesh, wire)
        del sent
        acc = torch.zeros_like(e).index_add_(0, all_i, all_v)
        # δ = scatter / N + β_m·e compiles, like the local mean, to
        # fma(scatter, 1/N, β_m·e) (the mesh tests tell the forms apart)
        _consensus_delta(e, acc, N, tier.beta_down)
        dvals, didx = _payload(e, tier.phi_down, impl, wire)
        didx = didx.long()
        wref.index_add_(0, didx, dvals)
        e.index_add_(0, didx, -dvals)
        _write_back_(state, wref, e, s, ref_spec)
        return state

    return pod_flat_sync


def _make_pod_leaf_sync(hfl_cfg, mesh):
    """``repro.core.hfl._leaf_sync_sparse(axis="pod")`` on each rank: every
    leaf block runs its own exact top-k uplink, "pod" all-gather, consensus
    and downlink. One cluster per pod, as in the reference (it reads row 0
    of each block)."""
    tier, N = hfl_cfg.tiers[1], hfl_cfg.num_clusters
    wire = wire_format_of(hfl_cfg)

    def pod_leaf_sync(state: HFLState):
        for P, R, Ep, E in zip(tree_leaves(state.params), tree_leaves(state.w_ref),
                               tree_leaves(state.eps), tree_leaves(state.e)):
            if P.shape[0] != 1:
                raise ValueError("the leaf layout on a pod mesh hosts one "
                                 "cluster per pod")
            size = R.numel()
            wref = R.reshape(-1).float()
            s = axpy_(P[0].reshape(-1).float() - wref, tier.beta_up,
                      Ep[0].reshape(-1).float())
            vals, idx = sp.pack_topk(s, sp.keep_count(size, tier.phi_up))
            if wire:
                vals = _wire_round_rows(vals, wire)
            s.index_add_(0, idx.long(), -vals)  # eps = s - sent
            all_v, all_i = _gather_pod(vals[None], idx[None], mesh, wire)
            acc = torch.zeros((size,), dtype=torch.float32, device=wref.device)
            acc.index_add_(0, all_i, all_v)
            delta = E.reshape(-1).float().clone()
            _consensus_delta(delta, acc, N, tier.beta_down)
            dvals, didx = sp.pack_topk(delta, sp.keep_count(size, tier.phi_down))
            if wire:
                dvals = _wire_round_rows(dvals, wire)
            d = sp.unpack_topk(dvals, didx, size)
            new = (wref + d).view(R.shape)
            E.copy_((delta - d).view(E.shape))
            Ep[0].copy_(s.view(Ep.shape[1:]))
            P.copy_(new.to(P.dtype).expand_as(P))
            R.copy_(new)
        return state

    return pod_leaf_sync


def _make_pod_dense_sync(hfl_cfg, mesh):
    """Dense averaging on a pod mesh: each block's rows of every pod,
    gathered over "pod", averaged as the single-process dense sync does."""
    from repro_torch.launch import mesh as M

    N = hfl_cfg.num_clusters

    def pod_dense_sync(state: HFLState):
        for P, R in zip(tree_leaves(state.params), tree_leaves(state.w_ref)):
            rows = M.all_gather(P, mesh, "pod").reshape((N,) + P.shape[1:])
            acc = rows[0].float().clone()
            for n in range(1, N):
                acc.add_(rows[n].float())
            mean = acc.mul_(recip_f32(N))
            P.copy_(mean.to(P.dtype).expand_as(P))
            R.copy_(mean.to(R.dtype))
        return state

    return pod_dense_sync


def _make_mesh_sync(plan):
    """The sync of ``plan`` on its mesh (see ``mesh_route``), with the
    reference's rejections; None for the "local" route."""
    from repro_torch.launch import mesh as M

    hfl_cfg = plan.hfl
    route = mesh_route(plan, M.mesh_shape(plan.mesh))
    if route == "local":
        return None
    if plan.collect_stats:
        raise ValueError(f"collect_stats is not supported on the {route} mesh "
                         "sync path (local flat topk/fused and dense only)")
    mode = hfl_cfg.sync_mode
    layout = plan.layout or hfl_cfg.sync_layout
    if route == "sharded":
        return _make_mesh_sharded_sync(hfl_cfg, plan.mesh)
    if mode == "dense":
        return _make_pod_dense_sync(hfl_cfg, plan.mesh)
    if mode not in ("sparse", "quantized_sparse"):
        raise ValueError(mode)
    if layout not in ("flat", "leaf"):
        raise ValueError(layout)
    if plan.param_specs is None:
        raise ValueError("sparse sync on a pod mesh needs param_specs")
    pods = M.axis_size(plan.mesh, "pod")
    if hfl_cfg.num_clusters % pods:
        raise ValueError(f"{hfl_cfg.num_clusters} clusters do not split over "
                         f"{pods} pods")
    if layout == "flat":
        return _make_pod_flat_sync(hfl_cfg, plan.mesh)
    return _make_pod_leaf_sync(hfl_cfg, plan.mesh)


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


def _no_stats(plan, path: str) -> None:
    if plan.collect_stats:
        raise ValueError(f"collect_stats is not supported on the {path} sync "
                         f"path (local flat topk/fused and dense only)")


@dataclass(frozen=True)
class SyncPlan:
    """Resolved spec of one consensus step build (see ``repro.core.hfl``)."""

    hfl: Any
    mesh: Any = None
    param_specs: Any = None
    layout: Optional[str] = None
    collect_stats: bool = False

    @classmethod
    def from_config(cls, hfl_cfg, *, mesh=None, param_specs=None,
                    layout=None, collect_stats: bool = False) -> "SyncPlan":
        return cls(hfl=hfl_cfg, mesh=mesh, param_specs=param_specs,
                   layout=layout, collect_stats=collect_stats)


_make_sync_step_warned = False


def make_sync_step(hfl_cfg, mesh=None, param_specs=None, *, layout=None,
                   collect_stats: bool = False):
    """Deprecated keyword-surface wrapper: build a :class:`SyncPlan` and
    call :func:`make_sync` instead. Warns once per process; behaviour is
    unchanged (the plan carries exactly these arguments)."""
    global _make_sync_step_warned
    if not _make_sync_step_warned:
        _make_sync_step_warned = True
        warnings.warn(
            "make_sync_step(hfl_cfg, mesh=..., param_specs=..., "
            "layout=..., collect_stats=...) is deprecated; build a "
            "SyncPlan (SyncPlan.from_config) and call make_sync(plan)",
            DeprecationWarning, stacklevel=2)
    return make_sync(SyncPlan(hfl=hfl_cfg, mesh=mesh,
                              param_specs=param_specs, layout=layout,
                              collect_stats=collect_stats))


def make_sync(plan: SyncPlan):
    """The consensus step of ``plan``: depth 2 dense, flat (or fused) and
    leaf layouts, the flat and dense ones optionally with in-sync
    statistics (``collect_stats``: the sync returns ``(state, stats)``);
    ``flat_shards > 1`` (fused Ω) the single-process sharded flat sync;
    on a mesh (``plan.mesh``, a ``launch.mesh`` DeviceMesh) the route of
    ``mesh_route``, each rank passing its rank-local state (``rank_state``);
    depth > 2 a :class:`HierSyncStep`. The reference's rejections hold."""
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
    mode = hfl_cfg.sync_mode
    _count_build("sync_step", mode=mode, layout=layout,
                 impl=hfl_cfg.omega_impl)
    if plan.mesh is not None:
        sync = _make_mesh_sync(plan)
        if sync is not None:
            sync.collect_stats = False
            return sync
    if mode == "dense":
        sync = _make_dense_sync(hfl_cfg, plan.collect_stats)
    elif mode in ("sparse", "quantized_sparse"):
        if layout not in ("flat", "leaf"):
            raise ValueError(layout)
        if layout == "leaf":
            _no_stats(plan, "leaf")
            sync = _make_leaf_sync(hfl_cfg)
        else:
            if hfl_cfg.omega_impl not in ("topk", "hist", "pallas", "fused"):
                raise ValueError(hfl_cfg.omega_impl)
            if hfl_cfg.flat_shards > 1:
                if hfl_cfg.omega_impl != "fused":
                    raise ValueError(
                        "flat_shards > 1 requires omega_impl='fused' (the "
                        "sharded flat sync is built on the fused per-shard "
                        "compaction)")
                _no_stats(plan, "sharded flat")
                sync = _make_flat_sharded_sync(hfl_cfg, hfl_cfg.flat_shards)
            else:
                sync = _make_flat_sync(hfl_cfg, plan.collect_stats)
    else:
        raise ValueError(mode)
    sync.collect_stats = plan.collect_stats
    return sync
