"""``fallback_ms.lm``: device ms a round of the operations launched inside
the fused selection's ``fused.select.fallback`` span, on synthetic Chrome
traces in the profiler's format (times in µs), as the program's other
span metrics are read."""
from types import SimpleNamespace

import pytest

from hflbench.harness import load_module
from hflbench.profiling import Trace


def _span(name, ts, dur, tid=1):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": dur, "tid": tid}


def _op(corr, launch, start, dur, api="cudaLaunchKernel"):
    """A device operation and the runtime call that launched it."""
    return [{"ph": "X", "cat": "cuda_runtime", "name": api, "ts": launch, "dur": 2,
             "tid": 1, "args": {"correlation": corr}},
            {"ph": "X", "cat": "kernel", "name": f"k{corr}", "ts": start, "dur": dur,
             "tid": 7, "args": {"correlation": corr}}]


def _trace(fallback=True):
    """Two profiled rounds: a train step, then a sync whose selection falls
    back (a memset, a kernel by cudaLaunchKernelExC and one by
    cudaLaunchKernel inside the span, and a kernel launched inside it that
    runs after it ends) or is answered from the candidates."""
    outcome = "fused.select.fallback" if fallback else "fused.select.candidates"
    ev = [_span("hflbench.window", 0, 20000), _span("hfl.train_step", 0, 4000),
          _span("hfl.sync", 5000, 4000), _span(outcome, 6000, 2000),
          _span("hfl.sync", 15000, 4000), _span(outcome, 16000, 1000)]
    ev += _op(1, 100, 110, 3000)                         # the train step
    ev += _op(2, 6100, 6110, 50, api="cudaMemsetAsync")  # the select's state
    ev += _op(3, 6200, 6210, 700, api="cudaLaunchKernelExC")
    ev += _op(4, 7900, 8000, 400)                        # runs past the span's end
    ev += _op(5, 8500, 8510, 300)                        # after the span: the gather
    ev += _op(6, 16100, 16110, 250)
    return Trace(ev)


INFO = {"rounds": 20, "trace_rounds": 2, "window_s": 1.0}


def _read(trace, info=INFO):
    return load_module("metrics", "fallback_ms.lm").read(SimpleNamespace(trace=trace, info=info))


@pytest.mark.parametrize("fallback,want", [
    # (0.05 + 0.7 + 0.4) ms in the first round, 0.25 in the second
    (True, (0.05 + 0.7 + 0.4 + 0.25) / 2),
    (False, 0.0)])
def test_fallback_ms_on_a_synthetic_trace(fallback, want):
    assert _read(_trace(fallback)) == pytest.approx(want)


def test_fallback_ms_silent_without_the_programs_spans_or_a_device():
    ev = [_span("hflbench.window", 0, 10000), _span("hflbench.train_step", 0, 6000)]
    ev += _op(1, 300, 310, 490)
    assert _read(Trace(ev)) is None
    assert _read(None) is None
    # the program's spans, but no device operation (a CPU run)
    cpu = [_span("hflbench.window", 0, 10000), _span("fused.select.fallback", 100, 500)]
    assert _read(Trace(cpu)) is None
