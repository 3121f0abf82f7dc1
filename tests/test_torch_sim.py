"""The simulator's depth-2 lockstep and deadline scenarios on the port
against the reference: the same numpy seed, the same converted init and
the same ``SyntheticLM`` batches through ``repro.sim`` and
``repro_torch.sim``.

  * The virtual timeline is numpy on both sides, so every trace row's
    ``t``, ``iter_s``, ``sync_s``, ``dropped``, ``deadline_s`` and
    ``bits_*`` and the whole trace meta (launch counts, access/fronthaul
    bits, the FL/HFL latencies) are EXACTLY equal. Measured accounting is
    compared across the packages with the ``bitmap`` codec, whose stream
    length depends on k and Q only: an index-dependent codec would also
    hold bf16 training's last-bit differences against the timeline.
    ``delta-varint`` is held inside the port (the ledger records exactly
    the host counts of the payloads the sync sends).
  * Losses and the final w_ref: the bf16 tolerances ``tests/
    test_torch_slice.py`` states (per-step mean losses rtol 1e-4; w_ref's
    gap to the reference <= 0.25 of the reference's move from init), and
    the cluster rows identical after the last sync.

Model: olmo-1b reduced and narrowed (2 layers, d_model 64, vocab 128), a
small radio (``LatencyParams(M=32, model_params=1e6)``: Alg. 2's greedy
loop and the broadcast Monte-Carlo scale with M and the payload), 4 steps
(2 syncs); the scenarios that pin no geometry run at ``2x2:H=2``.
"""
import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.configs.base import HFLConfig, parse_tiers_spec
from repro.core import hfl as jhfl
from repro.launch.steps import make_loss_fn as j_loss_fn
from repro.models.transformer import init_model as j_init
from repro.optim import SGDM as JSGDM
from repro.optim import warmup_step_decay as j_sched
from repro.sim import scenarios as JS
from repro.wireless.latency import LatencyParams as JLP
from repro_torch.configs import HFLConfig as THFLConfig
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import parse_tiers_spec as t_parse
from repro_torch.core import hfl as thfl
from repro_torch.data import SyntheticLM
from repro_torch.launch.steps import make_loss_fn as t_loss_fn
from repro_torch.optim import SGDM as TSGDM
from repro_torch.optim import warmup_step_decay as t_sched
from repro_torch.sim import scenarios as TS
from repro_torch.utils.convert import state_from_numpy
from repro_torch.utils.tree import tree_leaves
from repro_torch.wireless.latency import LatencyParams as TLP

torch.use_deterministic_algorithms(True)
torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
STEPS, SEQ, BPM, LR = 4, 16, 2, 0.25
RTOL = 1e-4
WREF_TOL = 0.25
NARROW = dict(d_model=64, num_heads=4, num_kv_heads=4, head_dim=16, d_ff=128,
              vocab_size=128)
PORTED = ("paper-fig3", "stragglers", "mobility", "dropout",
          "fault-dead-cluster", "diurnal", "prate-biased")
UNPORTED = {"hier-3tier": "item 13", "hier-deadline": "item 13"}
VIRTUAL = ("kind", "t", "step", "iter_s", "sync_s", "dropped", "deadline_s",
           "bits_sbs_ul", "bits_mbs_dl", "bits_sync_bcast")


def _batches(vocab, N, local_b):
    lm = SyntheticLM(vocab, seed=1)
    rng = np.random.default_rng(2)
    while True:
        yield lm.sample(N * local_b, SEQ, rng).reshape(N, local_b, SEQ)


def _flat(leaves):
    return np.concatenate([np.asarray(x, np.float32).ravel() for x in leaves])


def _run_both(name, *, accounting="analytic", codec="delta-varint", seed=0,
              masked=False, dtype=None, row_gaps=False, **engine_kw):
    """Both packages' engines for scenario ``name`` over the same init and
    batches -> (reference trace, port trace, w_ref gap, port state), and
    with ``row_gaps`` each cluster row's gap to the reference's row over
    that row's move from init. ``masked``: both run the async events
    through their masked train steps; ``dtype`` overrides the model's
    (bfloat16); ``engine_kw`` goes to both ``build_engine``s."""
    narrow = dict(NARROW, **({} if dtype is None else {"dtype": dtype}))
    jcfg = dataclasses.replace(get_config("olmo-1b").reduced(), **narrow)
    tcfg = dataclasses.replace(t_get_config("olmo-1b").reduced(), **narrow)
    jscn, tscn = JS.get_scenario(name), TS.get_scenario(name)
    jh = JS.apply_hfl_overrides(jscn, HFLConfig(
        tiers=parse_tiers_spec("2x2:H=2"), payload_accounting=accounting,
        codec=codec))
    th = TS.apply_hfl_overrides(tscn, THFLConfig(
        tiers=t_parse("2x2:H=2"), payload_accounting=accounting, codec=codec))
    N, local_b = th.num_clusters, th.mus_per_cluster * BPM
    base_lr = LR * th.total_mus * BPM / 128
    decay = (STEPS // 2, 3 * STEPS // 4)

    jopt = JSGDM(momentum=0.9, weight_decay=1e-4)
    jstate = jhfl.hfl_init(j_init(jax.random.PRNGKey(0), jcfg), jopt, jh)
    tstate = state_from_numpy(jax.tree.map(np.asarray, jstate), "cpu")
    w0 = _flat(jax.tree.leaves(jstate.w_ref))

    jeng = JS.build_engine(jscn, jh, lp=JLP(M=32, model_params=1e6), seed=seed,
                           **engine_kw)
    jsched = j_sched(base_lr, 1, decay)
    jstate, jtrace = jeng.run(
        jstate,
        jax.jit(jhfl.make_cluster_train_step(j_loss_fn(jcfg), jopt, jsched)),
        jhfl.jit_sync_step(jhfl.make_sync(jhfl.SyncPlan.from_config(jh))),
        ({"tokens": jnp.asarray(b)} for b in _batches(jcfg.vocab_size, N, local_b)),
        STEPS, masked_train_step=jax.jit(jhfl.make_masked_cluster_train_step(
            j_loss_fn(jcfg), jopt, jsched)) if masked else None)

    teng = TS.build_engine(tscn, th, lp=TLP(M=32, model_params=1e6), seed=seed,
                           **engine_kw)
    topt = TSGDM(momentum=0.9, weight_decay=1e-4)
    tsched = t_sched(base_lr, 1, decay)
    tstate, ttrace = teng.run(
        tstate,
        thfl.make_cluster_train_step(t_loss_fn(tcfg), topt, tsched),
        thfl.make_sync(thfl.SyncPlan(th)),
        ({"tokens": torch.from_numpy(b).long()}
         for b in _batches(tcfg.vocab_size, N, local_b)),
        STEPS, masked_train_step=thfl.make_masked_cluster_train_step(
            t_loss_fn(tcfg), topt, tsched) if masked else None)
    jw = _flat(jax.tree.leaves(jstate.w_ref))
    tw = _flat([t.numpy() for t in tree_leaves(tstate.w_ref)])
    gap = float(np.linalg.norm(tw - jw) / np.linalg.norm(jw - w0))
    if not row_gaps:
        return jtrace, ttrace, gap, tstate
    rows = []
    for n in range(N):
        jr = _flat([x[n] for x in jax.tree.leaves(jstate.params)])
        tr = _flat([x[n].float().numpy() for x in tree_leaves(tstate.params)])
        rows.append(float(np.linalg.norm(tr - jr)
                          / max(np.linalg.norm(jr - w0), 1e-30)))
    return jtrace, ttrace, gap, tstate, rows


def _check_same_run(jtrace, ttrace, gap, tstate):
    assert ttrace.meta == jtrace.meta
    assert len(ttrace.rows) == len(jtrace.rows) == STEPS + STEPS // 2
    for jr, tr in zip(jtrace.rows, ttrace.rows):
        assert set(tr) == set(jr)
        assert {k: tr[k] for k in VIRTUAL if k in tr} == \
            {k: jr[k] for k in VIRTUAL if k in jr}
    jl = [r["loss"] for r in jtrace.rows if "loss" in r]
    tl = [r["loss"] for r in ttrace.rows if "loss" in r]
    np.testing.assert_allclose(tl, jl, rtol=RTOL)
    assert gap <= WREF_TOL
    N = tree_leaves(tstate.params)[0].shape[0]
    for P in tree_leaves(tstate.params):  # the last step ended in a sync
        assert all(torch.equal(P[0], P[n]) for n in range(1, N))


@pytest.mark.parametrize("name", PORTED)
def test_scenario_replays_the_reference_timeline(name):
    jtrace, ttrace, gap, tstate = _run_both(name)
    _check_same_run(jtrace, ttrace, gap, tstate)
    if name in ("dropout", "fault-dead-cluster", "prate-biased"):
        assert any(r["dropped"] for r in ttrace.rows)  # the drop path ran


@pytest.mark.parametrize("name", ["paper-fig3", "dropout"])
def test_measured_accounting_replays_the_reference_timeline(name):
    jtrace, ttrace, gap, tstate = _run_both(name, accounting="measured",
                                            codec="bitmap")
    assert ttrace.meta["payload_accounting"] == "measured"
    assert ttrace.meta["events_sbs_ul"] > 0
    _check_same_run(jtrace, ttrace, gap, tstate)


def test_measured_ledger_records_the_probed_payload_bits():
    """delta-varint, inside the port: at every sync the ledger's
    fronthaul records are the host ``measure_bits`` of the payloads the
    probe finds, which are the payloads the sync then sends."""
    from repro_torch.comm.codecs import get_codec

    cfg = dataclasses.replace(t_get_config("olmo-1b").reduced(), **NARROW)
    scn = TS.get_scenario("paper-fig3")
    hfl = TS.apply_hfl_overrides(scn, THFLConfig(
        tiers=t_parse("2x2:H=2"), payload_accounting="measured"))
    N, local_b = hfl.num_clusters, hfl.mus_per_cluster * BPM
    rng = np.random.default_rng(0)
    state = thfl.hfl_init(_init_tree(cfg, rng), TSGDM(momentum=0.9), hfl)
    eng = TS.build_engine(scn, hfl, lp=TLP(M=32, model_params=1e6))
    codec = get_codec("delta-varint")
    host = []

    def probe_host(st, _inner=eng._probe_host):
        ups, (dv, di) = eng._probe.payloads(st)
        Q = eng.ledger.size
        host.append(([codec.measure_bits(v, i, Q) for v, i in ups],
                     codec.measure_bits(dv, di, Q)))
        return _inner(st)

    eng._probe_host = probe_host
    state, trace = eng.run(
        state,
        thfl.make_cluster_train_step(t_loss_fn(cfg), TSGDM(momentum=0.9),
                                     lambda t: 0.05),
        thfl.make_sync(thfl.SyncPlan(hfl)),
        ({"tokens": torch.from_numpy(b).long()}
         for b in _batches(cfg.vocab_size, N, local_b)),
        STEPS)
    syncs = [r for r in trace.rows if r["kind"] == "sync"]
    assert len(host) == len(syncs) == STEPS // 2
    for (ul, dl), row in zip(host, syncs):
        assert row["bits_sbs_ul"] == float(sum(ul))
        assert row["bits_mbs_dl"] == float(dl)
    assert eng.ledger.bits["sbs_ul"] == float(sum(sum(u) for u, _ in host))
    assert eng.ledger.bits["mbs_dl"] == float(sum(d for _, d in host))
    assert eng.ledger.events["sbs_ul"] == N * len(host)


def _init_tree(cfg, rng):
    """A port param tree of numpy draws in the shapes of init_model."""
    from repro_torch.models.transformer import init_model
    from repro_torch.utils.tree import tree_map

    return tree_map(lambda m: torch.from_numpy((0.02 * rng.standard_normal(
        tuple(m.shape))).astype(np.float32)).to(m.dtype),
        init_model(None, cfg, device="meta"))


def test_sat_out_cluster_rows_stay_bitwise():
    """fault-dead-cluster: cluster 2 never participates, so every train
    step leaves its params and optimizer rows as they were, bit for bit,
    while its loss is still computed and counted."""
    cfg = dataclasses.replace(t_get_config("olmo-1b").reduced(), **NARROW)
    scn = TS.get_scenario("fault-dead-cluster")
    hfl = TS.apply_hfl_overrides(scn, THFLConfig(tiers=t_parse("2x2:H=2")))
    N, local_b = hfl.num_clusters, hfl.mus_per_cluster * BPM
    opt = TSGDM(momentum=0.9)
    state = thfl.hfl_init(_init_tree(cfg, np.random.default_rng(0)), opt, hfl)
    inner = thfl.make_cluster_train_step(t_loss_fn(cfg), opt, lambda t: 0.05)
    seen = []

    def train_step(st, batch, keep=None):
        out = [n for n in range(N) if keep is not None and not keep[n]]
        before = [(P[n].clone(), M[n].clone()) for n in out for P, M in
                  zip(tree_leaves(st.params), tree_leaves(st.opt["m"]))]
        st, loss = inner(st, batch, keep=keep)
        after = [(P[n], M[n]) for n in out for P, M in
                 zip(tree_leaves(st.params), tree_leaves(st.opt["m"]))]
        assert all(torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16
                               else a.view(torch.int32),
                               b.view(torch.int16) if b.dtype == torch.bfloat16
                               else b.view(torch.int32))
                   for pair_b, pair_a in zip(before, after)
                   for b, a in zip(pair_b, pair_a))
        assert loss.shape == (N,) and torch.isfinite(loss).all()
        seen.append(out)
        return st, loss

    eng = TS.build_engine(scn, hfl, lp=TLP(M=32, model_params=1e6))
    eng.run(state, train_step, thfl.make_sync(thfl.SyncPlan(hfl)),
            ({"tokens": torch.from_numpy(b).long()}
             for b in _batches(cfg.vocab_size, N, local_b)), STEPS)
    assert seen == [[2]] * STEPS


def test_participation_resample_rows_equal_the_reference():
    """The dropped MUs' rows come from the same survivors as in the
    reference, gathered in one indexing op."""
    jscn, tscn = JS.get_scenario("dropout"), TS.get_scenario("dropout")
    jh = JS.apply_hfl_overrides(jscn, HFLConfig(tiers=parse_tiers_spec("3x3:H=2")))
    th = TS.apply_hfl_overrides(tscn, THFLConfig(tiers=t_parse("3x3:H=2")))
    jeng = JS.build_engine(jscn, jh, lp=JLP(M=32, model_params=1e6))
    teng = TS.build_engine(tscn, th, lp=TLP(M=32, model_params=1e6))
    toks = np.random.default_rng(3).integers(0, 100, (3, 6, 5))
    for mask in ([1, 0, 1, 0, 0, 1, 1, 1, 1], [0, 0, 0, 1, 0, 1, 0, 1, 0]):
        m = np.asarray(mask, bool)
        want = jeng._apply_participation({"tokens": jnp.asarray(toks)}, m)
        got = teng._apply_participation({"tokens": torch.from_numpy(toks)}, m)
        np.testing.assert_array_equal(got["tokens"].numpy(),
                                      np.asarray(want["tokens"]))


@pytest.mark.parametrize("name", sorted(UNPORTED))
def test_unported_scenario_raises_naming_its_item(name):
    scn = TS.get_scenario(name) if name != "scale-100k" else TS.SCENARIOS[name]
    hfl = TS.apply_hfl_overrides(scn, THFLConfig(tiers=t_parse("2x2:H=2")))
    with pytest.raises(NotImplementedError,
                       match=f"ROADMAP Queue 1 {UNPORTED[name]}"):
        TS.build_engine(scn, hfl)


def test_cli_runs_a_scenario_on_cpu():
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--scenario", "paper-fig3", "--steps", "2", "--batch-per-mu", "1",
         "--seq", "16"],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})
    assert res.returncode == 0, res.stderr
    lines = res.stdout.splitlines()
    assert any(l.startswith("[sim] scenario=paper-fig3 discipline=lockstep "
                            "residency=static virtual-wallclock=") for l in lines)
    assert any(l.startswith("[sim] t_fl_iter=") for l in lines)
    assert lines[-1].startswith("[train] first-loss=")
