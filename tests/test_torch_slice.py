"""The training path end to end: reduced olmo-1b at ``2x2:H=2`` for 6 steps (3
syncs), the same converted init and the same ``SyntheticLM`` batches
through the reference's ``run_hfl`` and the port's.

Tolerances: bf16 model math rounds differently in the two frameworks
(see test_torch_model), so the runs agree closely, not bitwise; the
consensus arithmetic itself is bitwise (test_torch_hfl).
  * per-step mean losses and the eval loss: rtol 1e-4. Measured at most
    4.0e-5 (fused) and 3.9e-5 (pallas); a port whose sync does nothing
    moves the per-step losses by 2.2e-4 (fused) and 3.8e-4 (pallas).
  * w_ref: ||port - reference|| / ||reference's move from init|| <= 0.25.
    Measured 0.065 (fused) and 0.095 (pallas); without syncs it is 1.0.
  * after step 6, which ends in a sync, the cluster rows are identical.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.configs.base import HFLConfig, parse_tiers_spec
from repro.core import hfl as jhfl
from repro.core.schedule import run_hfl as j_run_hfl
from repro.data import SyntheticLM as JSyntheticLM
from repro.launch.steps import make_loss_fn as j_loss_fn
from repro.models.transformer import forward as j_forward
from repro.models.transformer import init_model as j_init
from repro.optim import SGDM as JSGDM
from repro.optim import warmup_step_decay as j_sched
from repro_torch.configs import HFLConfig as THFLConfig
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import parse_tiers_spec as t_parse
from repro_torch.core import hfl as thfl
from repro_torch.core.schedule import run_hfl as t_run_hfl
from repro_torch.data import SyntheticLM
from repro_torch.launch.steps import make_loss_fn as t_loss_fn
from repro_torch.models.transformer import forward as t_forward
from repro_torch.optim import SGDM as TSGDM
from repro_torch.optim import warmup_step_decay as t_sched
from repro_torch.utils.convert import state_from_numpy
from repro_torch.utils.tree import tree_leaves

torch.use_deterministic_algorithms(True)
torch.set_num_threads(2)

STEPS, SEQ, BPM, LR = 6, 32, 2, 0.25
RTOL = 1e-4
WREF_TOL = 0.25


def _batches(vocab, N, local_b):
    lm = SyntheticLM(vocab, seed=1)
    rng = np.random.default_rng(2)
    while True:
        yield lm.sample(N * local_b, SEQ, rng).reshape(N, local_b, SEQ)


def _eval_tokens(vocab):
    return SyntheticLM(vocab, seed=1).sample(32, SEQ, np.random.default_rng(99))


def _flat(leaves):
    return np.concatenate([np.asarray(x, np.float32).ravel() for x in leaves])


def _wref_gap(jstate, tstate, w0):
    """||w_ref(port) - w_ref(reference)|| over the reference's own move of
    w_ref from its start (2-norms over the flat vector)."""
    jw = _flat(jax.tree.leaves(jstate.w_ref))
    tw = _flat([t.numpy() for t in tree_leaves(tstate.w_ref)])
    return float(np.linalg.norm(tw - jw) / np.linalg.norm(jw - w0))


def _eval_loss(logits, toks):
    lp = torch.log_softmax(torch.as_tensor(np.asarray(logits, np.float32)), -1)
    t = torch.from_numpy(toks).long()
    return float(-torch.gather(lp[:, :-1], -1, t[:, 1:, None]).mean())


@pytest.mark.parametrize("impl", ["fused", "pallas"])
def test_slice_matches_reference(impl):
    cfg = get_config("olmo-1b").reduced()
    tiers = parse_tiers_spec("2x2:H=2")
    hfl = HFLConfig(tiers=tiers, sync_mode="sparse", omega_impl=impl)
    N, local_b = hfl.num_clusters, hfl.mus_per_cluster * BPM
    base_lr = LR * hfl.total_mus * BPM / 128
    decay = (STEPS // 2, 3 * STEPS // 4)
    assert JSyntheticLM(cfg.vocab_size, seed=1).sample(2, 8).tolist() == \
        SyntheticLM(cfg.vocab_size, seed=1).sample(2, 8).tolist()

    jopt = JSGDM(momentum=0.9, weight_decay=1e-4)
    jstate = jhfl.hfl_init(j_init(jax.random.PRNGKey(0), cfg), jopt, hfl)
    tstate = state_from_numpy(jax.tree.map(np.asarray, jstate), "cpu")
    w0 = _flat(jax.tree.leaves(jstate.w_ref))

    jhist = []
    jstate = j_run_hfl(
        jstate,
        jax.jit(jhfl.make_cluster_train_step(
            j_loss_fn(cfg), jopt, j_sched(base_lr, max(STEPS // 20, 1), decay))),
        jhfl.jit_sync_step(jhfl.make_sync(jhfl.SyncPlan.from_config(hfl))),
        ({"tokens": jnp.asarray(b)} for b in _batches(cfg.vocab_size, N, local_b)),
        2, STEPS, lambda t, s, l: jhist.append(float(jnp.mean(l))))

    tcfg = t_get_config("olmo-1b").reduced()
    thfl_cfg = THFLConfig(tiers=t_parse("2x2:H=2"), sync_mode="sparse", omega_impl=impl)
    topt = TSGDM(momentum=0.9, weight_decay=1e-4)
    thist = []
    tstate = t_run_hfl(
        tstate,
        thfl.make_cluster_train_step(
            t_loss_fn(tcfg), topt, t_sched(base_lr, max(STEPS // 20, 1), decay)),
        thfl.make_sync(thfl.SyncPlan(thfl_cfg)),
        ({"tokens": torch.from_numpy(b).long()} for b in _batches(tcfg.vocab_size, N, local_b)),
        2, STEPS, lambda t, s, l: thist.append(float(l.mean())))

    assert len(thist) == len(jhist) == STEPS
    for P in tree_leaves(tstate.params):  # step 6 ended in a sync
        assert all(torch.equal(P[0], P[n]) for n in range(1, N))
    assert _wref_gap(jstate, tstate, w0) <= WREF_TOL
    np.testing.assert_allclose(thist, jhist, rtol=RTOL)
    toks = _eval_tokens(cfg.vocab_size)
    jl, _ = j_forward(jhfl.serving_params(jstate), jnp.asarray(toks), cfg)
    with torch.no_grad():
        tl, _ = t_forward(thfl.serving_params(tstate), torch.from_numpy(toks).long(), tcfg)
    j_eval, t_eval = _eval_loss(jl, toks), _eval_loss(tl.float(), toks)
    assert np.isfinite(t_eval)
    np.testing.assert_allclose(t_eval, j_eval, rtol=RTOL)
