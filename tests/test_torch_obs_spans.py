"""The program's own spans (``repro_torch.obs.spans.span``): nothing when no
one listens; under ``torch.profiler`` the train step's, the flat sync's (on
the ``pallas`` and the ``fused`` route) and the paper engine's spans, nested
as the layers call each other; the same spans in an installed tracer, on
the profiler's epoch clock; and the state bitwise the same with spans on
and off."""
import json
import os
import tempfile

import pytest
import torch

from repro_torch.configs.base import HFLConfig, ModelConfig, TierConfig
from repro_torch.core import hfl as H
from repro_torch.core.federated import FaithfulHFL
from repro_torch.launch.steps import make_loss_fn
from repro_torch.models.transformer import init_model
from repro_torch.obs import ObsConfig, SpanTracer, Telemetry, use_registry
from repro_torch.obs.spans import NULL_SPAN, current_tracer, span, use_tracer
from repro_torch.optim import SGDM

torch.set_num_threads(2)

TINY = ModelConfig(name="t", arch_type="dense", num_layers=2, d_model=32, num_heads=4,
                   num_kv_heads=2, d_ff=64, vocab_size=61, norm_type="nonparametric_ln",
                   tie_embeddings=True, dtype="float32", remat=False)
N = 2


def _hfl(impl):
    return HFLConfig(tiers=(TierConfig(fanout=2, period=1, phi_up=0.99, phi_down=0.9),
                            TierConfig(fanout=N, period=2, phi_up=0.9, phi_down=0.9,
                                       beta_up=0.5, beta_down=0.2)),
                     momentum=0.9, sync_mode="sparse", omega_impl=impl)


def _lm(impl):
    """A tiny HFL state, its train step and sync, and a batch."""
    opt = SGDM(momentum=0.9)
    hfl = _hfl(impl)
    state = H.hfl_init(init_model(torch.Generator().manual_seed(0), TINY, device="cpu"),
                       opt, hfl)
    train = H.make_cluster_train_step(make_loss_fn(TINY), opt, lambda t: 0.1)
    sync = H.make_sync(H.SyncPlan(hfl))
    tokens = torch.randint(0, TINY.vocab_size, (N, 2, 16),
                           generator=torch.Generator().manual_seed(1))
    return state, train, sync, {"tokens": tokens}


def _lm_round(impl):
    state, train, sync, batch = _lm(impl)
    state, _ = train(state, batch)
    return sync(state)


def _faithful():
    Q, K = 1000, 4
    gen = torch.Generator().manual_seed(2)
    sim = FaithfulHFL(w0=torch.randn(Q, generator=gen), hfl_cfg=_hfl("pallas"),
                      lr_schedule=lambda t: 0.05,
                      loss_fn=lambda w, b: ((w[None, :] - b) ** 2).mean(),
                      sparsify_impl="pallas")
    batches = torch.randn(K, 3, Q, generator=gen)
    return sim, batches


def _faithful_round():
    sim, batches = _faithful()
    for _ in range(2):  # the second iteration makes the consensus (H = 2)
        sim.step(batches)
    return sim


def _profiled(fn):
    """fn() under torch.profiler -> (its result, [(name, start µs, end µs)]
    of the user annotations on the epoch clock)."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            obj = json.load(fh)
    base = obj.get("baseTimeNanoseconds", 0) / 1e3
    marks = sorted((e["name"], base + e["ts"], base + e["ts"] + e["dur"])
                   for e in obj["traceEvents"]
                   if e.get("ph") == "X" and e.get("cat") == "user_annotation")
    return out, sorted(marks, key=lambda m: m[1])


def _named(marks, name):
    return [m for m in marks if m[0] == name]


def _within(marks, child, parent):
    """The ``child`` marks that lie inside some ``parent`` mark."""
    outer = _named(marks, parent)
    return [m for m in _named(marks, child) if any(x <= m[1] and m[2] <= y for _, x, y in outer)]


def _inside(marks, child, parent):
    """Every ``child`` mark lies inside some ``parent`` mark; -> their count."""
    n = len(_named(marks, child))
    assert len(_within(marks, child, parent)) == n, (child, parent)
    return n


def test_span_is_null_and_records_nothing_without_a_listener():
    tr = SpanTracer()
    with use_tracer(None):
        assert current_tracer() is None
        sp = span("hfl.train_step", 3)
        assert sp is NULL_SPAN
        with sp:
            pass
        _lm_round("pallas")
    assert tr.events == []
    # a Telemetry without host spans installs no tracer
    with use_tracer(None), use_registry(None):
        Telemetry(ObsConfig(enabled=True, host_spans=False))
        assert current_tracer() is None and span("x") is NULL_SPAN


def test_train_step_spans_nest_under_the_step():
    state, train, _, batch = _lm("pallas")
    _, marks = _profiled(lambda: train(state, batch))
    assert len(_named(marks, "hfl.train_step")) == 1
    for child in ("hfl.train.forward", "hfl.train.backward", "hfl.train.optimizer"):
        assert _inside(marks, child, "hfl.train_step") == N
    # forward, backward, optimizer in that order, cluster by cluster
    order = [m[0] for m in marks if m[0].startswith("hfl.train.")]
    assert order == ["hfl.train.forward", "hfl.train.backward", "hfl.train.optimizer"] * N


@pytest.mark.parametrize("impl", ["pallas", "fused"])
def test_flat_sync_spans_nest_under_the_sync(impl):
    state, train, sync, batch = _lm(impl)
    state, _ = train(state, batch)
    _, marks = _profiled(lambda: sync(state))
    assert len(_named(marks, "hfl.sync")) == 1
    ups = N if impl == "pallas" else 1  # one select_topk_rows call for the N rows
    for child, n in (("hfl.sync.drift", 1), ("hfl.sync.select_up", ups),
                     ("hfl.sync.scatter", ups), ("hfl.sync.delta", 1),
                     ("hfl.sync.select_down", 1), ("hfl.sync.adopt", 1)):
        assert _inside(marks, child, "hfl.sync") == n, child
    if impl == "pallas":
        # one count and the first_true chunks a selection, inside the selections
        assert len(_within(marks, "wait.mask_count", "hfl.sync.select_up")) == N
        assert len(_within(marks, "wait.mask_count", "hfl.sync.select_down")) == 1
        assert len(_named(marks, "wait.first_true")) >= N + 1
        assert not [m for m in marks if m[0].startswith("fused.")]
    else:
        # one outcome a call: the uplinks' and the downlink's; a row check
        # each, until a row sends its call to the exact path
        for sel, rows in (("hfl.sync.select_up", N), ("hfl.sync.select_down", 1)):
            outcome = [m for m in marks if m[0].startswith("fused.select.")
                       and _within([m] + _named(marks, sel), m[0], sel)]
            assert len(outcome) == 1
            checks = len(_within(marks, "wait.fused_rows", sel))
            assert checks == rows if outcome[0][0].endswith("candidates") else 1 <= checks <= rows
        assert len(_named(marks, "wait.topk")) >= 3  # the finishes' radix selects
    for name, a, b in marks:  # every wait lies inside the sync
        if name.startswith("wait."):
            assert any(x <= a and b <= y for _, x, y in _named(marks, "hfl.sync"))


def test_faithful_iteration_spans():
    sim, batches = _faithful()
    _, marks = _profiled(lambda: [sim.step(batches) for _ in range(2)])
    assert len(_named(marks, "faithful.iteration")) == 2
    K = 4
    assert _inside(marks, "faithful.mu_pass", "faithful.iteration") == 2 * K
    assert _inside(marks, "faithful.dgc", "faithful.iteration") == 2 * K
    assert _inside(marks, "faithful.sbs", "faithful.iteration") == 2 * (N + 1)
    assert _inside(marks, "faithful.consensus", "faithful.iteration") == 1
    # each iteration reads its loss and |ĝ| back once, after the iteration
    reads = _named(marks, "wait.readback")
    assert len(reads) == 2
    for (_, a, _), (_, _, b) in zip(reads, _named(marks, "faithful.iteration")):
        assert a >= b


@pytest.mark.parametrize("run", [lambda: _lm_round("fused"), _faithful_round],
                         ids=["lm-fused", "faithful"])
def test_tracer_gets_the_same_spans_on_the_profilers_clock(run):
    tr = SpanTracer()
    with use_tracer(tr):
        _, marks = _profiled(run)
    host = [e for e in tr.events if e["ph"] == "X" and e["cat"] == "host"]
    epoch = tr.to_chrome()["metadata"]["host_epoch_ns"] / 1e3
    assert sorted(e["name"] for e in host) == sorted(m[0] for m in marks)
    for name in {e["name"] for e in host}:
        mine = sorted(epoch + e["ts"] for e in host if e["name"] == name)
        prof = sorted(a for _, a, _ in _named(marks, name))
        assert max(abs(x - y) for x, y in zip(mine, prof)) < 1e3, name  # within 1 ms
    top = [e for e in host if e["name"] in ("hfl.train_step", "hfl.sync",
                                            "faithful.iteration")]
    assert top and all("step" in e["args"] for e in top)


def _flat(state):
    trees = (state.params, state.opt, state.w_ref, state.eps, state.e)
    return torch.cat([t.reshape(-1).float() for tree in trees for t in H.tree_leaves(tree)])


@pytest.mark.parametrize("impl", ["pallas", "fused"])
def test_state_is_bitwise_the_same_with_spans_on_and_off(impl):
    with use_tracer(None):
        off = _lm_round(impl)
    with use_tracer(SpanTracer()):
        on, _ = _profiled(lambda: _lm_round(impl))
    assert torch.equal(_flat(off), _flat(on))
    with use_tracer(None):
        f_off = _faithful_round().state
    with use_tracer(SpanTracer()):
        f_on = _profiled(_faithful_round)[0].state
    for key, v in f_off.items():
        assert torch.equal(torch.as_tensor(v), torch.as_tensor(f_on[key])), key
