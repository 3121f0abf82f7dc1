"""The readers of the program's own spans (``metrics/_program.py`` and the
metrics on it), on synthetic Chrome traces in the profiler's format (times
in µs), and on one tiny traced CPU run."""
import json
from types import SimpleNamespace

import pytest

from _tiny import ROOT, command
from hflbench.harness import load_module
from hflbench.metrics import _program as p
from hflbench.profiling import Trace

LM_METRICS = ("optimizer_ms.lm", "optimizer_ms.long", "train_idle_ms.lm",
              "optimizer_idle_ms.lm", "host_waits.lm", "wait_idle_ms.lm", "fused_answered.lm")
FAITHFUL_METRICS = ("mu_pass_idle_ms.faithful", "dgc_ms.faithful")


def _span(name, ts, dur, tid=1):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": dur, "tid": tid}


def _op(corr, launch, start, dur, launch_tid=1):
    """A kernel and the runtime call that launched it."""
    return [{"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": launch,
             "dur": 2, "tid": launch_tid, "args": {"correlation": corr}},
            {"ph": "X", "cat": "kernel", "name": f"k{corr}", "ts": start, "dur": dur,
             "tid": 7, "args": {"correlation": corr}}]


def _lm_trace():
    """One profiled round: a train step (forward, a backward op launched from
    autograd's thread, the optimizer) and a sync with one blocking read and
    two fused selections, one answered from the candidates."""
    ev = [_span("hflbench.window", 0, 10000), _span("hflbench.train_step", 0, 6000),
          _span("hfl.train_step", 100, 5800), _span("hfl.train.forward", 200, 800),
          _span("hfl.train.backward", 1000, 2000), _span("hfl.train.optimizer", 3000, 2000),
          _span("hfl.sync", 6000, 3000), _span("wait.first_true", 7000, 500),
          _span("fused.select.candidates", 8000, 100), _span("fused.select.fallback", 8200, 400)]
    ev += _op(1, 300, 310, 490)                   # forward
    ev += _op(2, 1500, 1510, 990, launch_tid=2)   # backward, from autograd's thread
    ev += _op(3, 3100, 3110, 490)                 # optimizer
    ev += _op(4, 6900, 6910, 290)                 # the read in wait.first_true drains it
    ev += _op(5, 7800, 7810, 90)
    return Trace(ev)


def _faithful_trace():
    """One profiled iteration: two MU passes, a DGC step after each."""
    ev = [_span("hflbench.window", 0, 4000), _span("faithful.iteration", 50, 3900),
          _span("faithful.mu_pass", 100, 1000), _span("faithful.dgc", 1100, 500),
          _span("faithful.mu_pass", 1600, 1000), _span("faithful.dgc", 2600, 500),
          _span("wait.readback", 3950, 40)]
    ev += _op(1, 150, 200, 600) + _op(2, 1200, 1210, 300)
    ev += _op(3, 1700, 1710, 700) + _op(4, 2700, 2710, 200)
    return Trace(ev)


# the clean window: 200 rounds in 1 s, 5 ms a round, of which the profiled
# round's 2.35 ms of device work leaves 2.65 ms idle
LM_INFO = {"rounds": 200, "trace_rounds": 1, "window_s": 1.0}
BUSY, IDLE = 0.00235, 0.01 - 0.00235
CLEAN = 1.0 / 200 - BUSY


def _read(name, trace, info):
    return load_module("metrics", name).read(SimpleNamespace(trace=trace, info=info))


def test_an_op_belongs_to_the_span_its_launch_lies_in_on_any_thread():
    t = _lm_trace()
    assert t.busy_s == pytest.approx(BUSY)
    assert p.device_s_launched_in(t, "hfl.train.backward") == pytest.approx(0.00099)
    assert p.device_s_launched_in(t, "hfl.train.forward") == pytest.approx(0.00049)
    assert p.device_s_launched_in(t, "hfl.train_step") == pytest.approx(0.00049 + 0.00099 + 0.00049)


@pytest.mark.parametrize("name,want", [
    ("optimizer_ms.lm", 0.49), ("optimizer_ms.long", 0.49),
    # idle inside the step: 5.8 ms less 1.97 ms busy, as a share of the
    # round's 7.65 ms idle, of the clean round's 2.65 ms
    ("train_idle_ms.lm", 1e3 * 0.00383 / IDLE * CLEAN),
    ("optimizer_idle_ms.lm", 1e3 * 0.00151 / IDLE * CLEAN),
    ("host_waits.lm", 1.0),
    # the gap from 7.2 ms (inside the read) to the next launch's op at 7.81 ms
    ("wait_idle_ms.lm", 1e3 * 0.00061 / IDLE * CLEAN),
    ("fused_answered.lm", 50.0)])
def test_lm_metrics_on_a_synthetic_trace(name, want):
    assert _read(name, _lm_trace(), LM_INFO) == pytest.approx(want)


@pytest.mark.parametrize("name,want", [
    # 3 iterations in 6 ms: 2 ms an iteration, 1.8 ms busy in the profiled
    # one; the passes' 2 ms hold 1.3 ms of work, so 0.7 of its 2.2 ms idle
    ("mu_pass_idle_ms.faithful", 1e3 * 0.0007 / (0.004 - 0.0018) * (0.002 - 0.0018)),
    ("dgc_ms.faithful", 0.5)])
def test_faithful_metrics_on_a_synthetic_trace(name, want):
    info = {"iterations": 3, "trace_iterations": 1, "window_s": 0.006}
    assert _read(name, _faithful_trace(), info) == pytest.approx(want)


@pytest.mark.parametrize("name", LM_METRICS + FAITHFUL_METRICS)
def test_silent_without_the_programs_spans(name):
    """A program without spans (the harness's own marks alone) reads nothing."""
    ev = [_span("hflbench.window", 0, 10000), _span("hflbench.train_step", 0, 6000)]
    ev += _op(1, 300, 310, 490)
    info = {**LM_INFO, "iterations": 3, "trace_iterations": 1}
    assert _read(name, Trace(ev), info) is None
    assert _read(name, None, info) is None


def test_traced_cpu_run_counts_the_waits_and_leaves_device_time_silent():
    rc, out, err = command(ROOT, "olmo1b-sync-h2", trace=1)
    assert rc == 0, err[-2000:]
    line = json.loads(out.strip().splitlines()[-1])
    # the pallas sync's mask counts and first_true chunks, three selections a round
    assert line["metrics"]["host_waits.lm"]["value"] >= 6
    for name in LM_METRICS:
        if name != "host_waits.lm":
            assert name not in line["metrics"]
