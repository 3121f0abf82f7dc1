"""Faithful FL / HFL simulator (Alg. 1, 3, 4, 5) on flat parameter vectors:
the port of ``repro.core.federated``, the paper-exact engine of the
accuracy experiments (Table III / Fig. 6) and the equivalence tests.

It keeps explicit per-MU momentum/error buffers (u_k, v_k), per-SBS
downlink/uplink errors (e_n, ε_n) and the MBS error (e), and sparsifies
all four hops:

  MU --φ_MU^ul--> SBS --φ_SBS^dl--> MU        (every iteration)
  SBS --φ_SBS^ul--> MBS --φ_MBS^dl--> SBS     (every H iterations)

with the reference's reading of Algorithm 5 (the SBS rebases on the
MU-visible W̃_n and re-injects its residual discounted by β_s; the MBS
residual is discounted by β_m). All φ = 0 is periodic averaging
(Algorithm 3), and N = 1, H = 1, φ = 0 plain synchronous FL.

Where the reference vmaps, the port loops: over the K MUs for the
gradient (one forward/backward per MU at its own batch, so BatchNorm's
batch statistics stay per MU) and the DGC step, and over the N rows of
each SBS hop. ``lax.cond`` on the sync is a host branch on the integer
step. The f32 arithmetic is the reference's as XLA compiles it
(``utils/fp``): the SBS update ``w - lr·ĝ`` is one fused multiply-add,
the drifts fuse ``β·err`` into their add, means multiply by the f32
reciprocal, and every mask is a select. So from the same state and
gradients the state is bitwise the reference's on the CPU.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch

from repro_torch.core import sparsify as sp
from repro_torch.utils.fp import axpy_, fma_f32, recip_f32


@dataclass
class FaithfulHFL:
    """Faithful Alg. 5 simulator over flat parameter vectors.

    Provide either ``loss_fn(w_vec, batch) -> scalar`` (gradients from
    autograd on a flat leaf; ``step`` reports the real mean training loss)
    or ``grad_fn(w_vec, batch) -> grad_vec`` (loss reported as NaN);
    ``loss_fn`` wins if both are given. The state lives on ``w0``'s device.
    """

    w0: torch.Tensor  # initial flat model [Q]
    hfl_cfg: "HFLConfig"
    lr_schedule: Callable
    grad_fn: Optional[Callable] = None
    loss_fn: Optional[Callable] = None
    sparsify_impl: str = "topk"

    def __post_init__(self):
        if self.grad_fn is None and self.loss_fn is None:
            raise ValueError("FaithfulHFL needs loss_fn or grad_fn")
        N, K = self.hfl_cfg.num_clusters, self.hfl_cfg.total_mus
        w0 = self.w0.detach()
        zeros = lambda *shape: torch.zeros(shape, dtype=w0.dtype, device=w0.device)
        Q = w0.numel()
        self.state = {
            "w_tilde_n": w0[None].repeat(N, 1),  # MU-visible models
            "u": zeros(K, Q),  # per-MU momentum (Alg. 4)
            "v": zeros(K, Q),  # per-MU error accumulation
            "e_n": zeros(N, Q),  # SBS downlink residual
            "eps_n": zeros(N, Q),  # SBS uplink residual
            "w_ref": w0.clone(),  # global reference W̃
            "e": zeros(Q),  # MBS downlink residual
            "t": 0,
        }

    def step(self, batches):
        """batches: a tensor, tuple, list or dict of tensors with leading
        axis K (one slice per MU). Returns ``loss`` (mean training loss
        over the MUs; NaN with only ``grad_fn``) and ``sparse_grad_abs``
        (mean |ĝ_n| of the SBS aggregates), as floats."""
        self.state, metrics = _hfl_iteration(
            self.state, batches, grad_fn=self.grad_fn, loss_fn=self.loss_fn,
            hfl=self.hfl_cfg, lr_schedule=self.lr_schedule,
            impl=self.sparsify_impl)
        return {k: float(v) for k, v in metrics.items()}

    @property
    def global_model(self):
        return self.state["w_ref"]

    @property
    def cluster_models(self):
        return self.state["w_tilde_n"]


def _take(batches, k: int):
    """MU k's slice of a batch pytree (tensor, tuple, list or dict)."""
    if isinstance(batches, dict):
        return {n: _take(b, k) for n, b in batches.items()}
    if isinstance(batches, (tuple, list)):
        return type(batches)(_take(b, k) for b in batches)
    return batches[k]


def _mu_grad(w, batch, grad_fn, loss_fn):
    """(flat gradient, loss or None) of one MU at model row ``w``."""
    if loss_fn is None:
        return grad_fn(w, batch), None
    leaf = w.detach().requires_grad_(True)
    with torch.enable_grad():
        loss = loss_fn(leaf, batch)
        (g,) = torch.autograd.grad(loss, leaf)
    return g, loss.detach()


def _sum_rows(rows):
    """Σ over a leading axis as XLA's reduce computes it: rows in order."""
    acc = rows[0].clone()
    for r in rows[1:]:
        acc.add_(r)
    return acc


def _hop(x, phi: float, impl: str):
    """One sparse hop: (x + nothing sent, residual) = (sent, x - sent)."""
    sent, _ = sp.omega(x, phi, impl=impl)
    return sent, x - sent


@torch.no_grad()
def _hfl_iteration(state, batches, *, grad_fn, loss_fn, hfl, lr_schedule, impl):
    N, M = hfl.num_clusters, hfl.mus_per_cluster
    tier0, tier1 = hfl.tiers[0], hfl.tiers[1]
    lr = float(lr_schedule(state["t"]))

    # ---- per-MU gradient + DGC sparsification (Alg. 4 l.4-13) ----
    u, v = torch.empty_like(state["u"]), torch.empty_like(state["v"])
    ghat_n, losses = [], []
    for n in range(N):
        ghats = []
        for m in range(M):
            k = n * M + m
            g, loss = _mu_grad(state["w_tilde_n"][n], _take(batches, k),
                               grad_fn, loss_fn)
            if loss is not None:
                losses.append(loss)
            gk, u[k], v[k] = sp.dgc_step(state["u"][k], state["v"][k], g,
                                         hfl.momentum, tier0.phi_up, impl=impl)
            ghats.append(gk)
        ghat_n.append(_sum_rows(ghats).mul_(recip_f32(M)))  # jnp.mean

    # ---- SBS aggregation + model update + sparse downlink to MUs ----
    w_tilde_n, e_n = torch.empty_like(state["w_tilde_n"]), torch.empty_like(state["e_n"])
    for n in range(N):
        w = state["w_tilde_n"][n]
        # target = (w - lr·ĝ_n) + β_s·e_n, each add one fused multiply-add
        target = fma_f32(tier1.beta_up, state["e_n"][n], fma_f32(-lr, ghat_n[n], w))
        sent, e_n[n] = _hop(target - w, tier0.phi_down, impl)
        w_tilde_n[n] = w + sent

    # ---- every H: SBS <-> MBS global consensus (Alg. 5 l.22-39) ----
    t_new = state["t"] + 1
    eps_n, w_ref, e = state["eps_n"], state["w_ref"], state["e"]
    if t_new % tier1.period == 0:
        eps_n, sent_n = torch.empty_like(eps_n), []
        for n in range(N):
            dn = axpy_(w_tilde_n[n] - w_ref, tier1.beta_up, state["eps_n"][n])
            sent, eps_n[n] = _hop(dn, tier1.phi_up, impl)
            sent_n.append(sent)
        # δ = Σ sent_n / N + β_m·e: the mean's reciprocal multiply fused
        delta = fma_f32(recip_f32(N), _sum_rows(sent_n), e * tier1.beta_down)
        d, e = _hop(delta, tier1.phi_down, impl)
        w_ref = w_ref + d
        # MBS -> SBS -> MU downlink of the new reference (sparse dl hop)
        for n in range(N):
            dn = axpy_(w_ref - w_tilde_n[n], tier1.beta_up, e_n[n])
            sent, e_n[n] = _hop(dn, tier0.phi_down, impl)
            w_tilde_n[n] = w_tilde_n[n] + sent

    new_state = {"w_tilde_n": w_tilde_n, "u": u, "v": v, "e_n": e_n,
                 "eps_n": eps_n, "w_ref": w_ref, "e": e, "t": t_new}
    mean_loss = (torch.stack(losses).mean() if losses
                 else torch.tensor(float("nan")))
    return new_state, {"loss": mean_loss,
                       "sparse_grad_abs": torch.stack(ghat_n).abs().mean()}
