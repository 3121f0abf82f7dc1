"""The trace reduction: busy time, kernels by name, time under a host
operation, device time inside a span, and the idle gaps by host activity,
on a synthetic Chrome trace (times in µs, as the profiler writes them)."""
import pytest

from _tiny import ROOT  # noqa: F401  (puts the repo on the path)
from hflbench.profiling import Trace, _holds


def _trace():
    ev = [{"ph": "X", "cat": "user_annotation", "name": "hflbench.window", "ts": 0, "dur": 10000, "tid": 1},
          {"ph": "X", "cat": "user_annotation", "name": "hflbench.sync", "ts": 100, "dur": 5000, "tid": 1},
          {"ph": "X", "cat": "cpu_op", "name": "aten::cudnn_convolution", "ts": 6000, "dur": 50, "tid": 1}]
    ev += [{"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 200 + i, "dur": 0.5, "tid": 1}
           for i in range(300)]
    ev += [{"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 300, "dur": 2, "tid": 1,
            "args": {"correlation": 5}},
           {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 6010, "dur": 2, "tid": 1,
            "args": {"correlation": 6}},
           {"ph": "X", "cat": "kernel", "name": "void ns::update_max_kernel<4>(float)", "ts": 305,
            "dur": 1000, "tid": 7, "args": {"correlation": 5}},
           {"ph": "X", "cat": "kernel", "name": "sm80_xmma_fprop(float)", "ts": 6020, "dur": 500,
            "tid": 7, "args": {"correlation": 6}},
           {"ph": "X", "cat": "kernel", "name": "late", "ts": 9900, "dur": 500, "tid": 7}]
    return Trace(ev)


def test_busy_window_and_kernels():
    t = _trace()
    assert t.window_s == pytest.approx(0.01)
    assert t.busy_s == pytest.approx(0.0016)  # the last kernel is clipped to the window
    assert t.kernels("update_max_kernel") == (pytest.approx(0.001), 1)
    assert t.kernels("update_max") == (0.0, 0)


def test_time_under_host_ops_and_spans():
    t = _trace()
    assert t.under_host_op("convolution") == pytest.approx(0.0005)
    assert t.busy_in("hflbench.sync") == [pytest.approx(0.001)]


def test_breakdown_names_the_host_activity_of_each_gap():
    b = _trace().breakdown()
    assert b["device_ops"][0] == ["void ns::update_max_kernel<4>(float)", pytest.approx(0.001)]
    gaps = dict(b["idle_gaps"])
    # each gap goes to the innermost host event at its middle: 0-0.305 ms and
    # 1.305-6.02 ms lie in the sync span, 6.52-9.9 ms in none
    assert gaps["hflbench.sync"] == pytest.approx(0.00502)
    assert gaps["host outside any marked call"] == pytest.approx(0.00338)
    assert sum(gaps.values()) == pytest.approx(0.01 - 0.0016)


@pytest.mark.parametrize("name,needle,hit", [
    ("void a::dq_wgmma_kernel<1>(x)", "dq_wgmma_kernel", True),
    ("void a::dq_kernel<1>(x)", "dq_wgmma_kernel", False),
    ("select_kernel(float const*)", "select_kernel", True),
    ("block_select_kernel", "select_kernel", False)])
def test_kernel_names_match_whole_identifiers(name, needle, hit):
    assert _holds(name, needle) is hit
