"""The DeepSeek-V2-Lite cell runs end to end through the command at the
tests' size, its check passes on the sound program and catches each planted
fault, and the expert layer's readers read its spans (``moe.*``) on a
synthetic trace and nothing without them."""
import json
from types import SimpleNamespace

import pytest

from _tiny import KEYS, ROOT, command, in_process
from hflbench.harness import load_json, load_module, overlay
from hflbench.metrics import _moe_yardstick as my
from hflbench.profiling import Trace

CELL = "dsv2lite-train4k-h4"
FAULTS = ["unchanged", "half_batch", "no_exchange", "altered"]
MOE_METRICS = ("moe_experts_ms.moe", "moe_route_ms.moe", "grouped_mm_roofline.moe")


def test_moe_cell_prints_the_contracts_last_line_and_the_load_spread():
    rc, out, err = command(ROOT, CELL)
    assert rc == 0, err[-2000:]
    line = json.loads(out.strip().splitlines()[-1])
    assert tuple(line)[:5] == KEYS and list(line)[-1] == "compared"
    assert line["correct"] is True, line["compared"]
    assert {"setup_s", "peak_mem_gb", "train_tokens_per_s"} == set(line["metrics"])
    assert line["attempted"] > 0 and line["failed"] == 0
    assert "held-expert load over the window (2 experts" in err


def test_moe_traced_run_reads_mfu_and_leaves_device_time_silent():
    rc, out, err = command(ROOT, CELL, trace=1)
    assert rc == 0, err[-2000:]
    metrics = json.loads(out.strip().splitlines()[-1])["metrics"]
    assert {"mfu.moe", "train_step_ms.lm", "sync_ms.lm"} <= set(metrics)
    assert 0 < metrics["mfu.moe"]["value"]
    assert not any(k in metrics for k in MOE_METRICS + ("flash_attn_fwd_roofline.moe",))


def test_sound_moe_run_is_correct():
    assert in_process(CELL)["correct"] is True


@pytest.mark.parametrize("fault", FAULTS)
def test_planted_fault_in_the_moe_cell_comes_out_not_correct(fault):
    line = in_process(CELL, fault)
    assert line["correct"] is False, line["compared"]


def test_paper_fused_cell_is_correct():
    line = in_process("resnet18-paper-fused")
    assert line["correct"] is True, line["compared"]
    assert "train_images_per_s" in line["metrics"]


def _span(name, ts, dur, tid=1):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": dur, "tid": tid}


def _op(corr, launch, start, dur, launch_tid=1):
    return [{"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": launch,
             "dur": 2, "tid": launch_tid, "args": {"correlation": corr}},
            {"ph": "X", "cat": "kernel", "name": f"k{corr}", "ts": start, "dur": dur,
             "tid": 7, "args": {"correlation": corr}}]


def _ctx(with_moe_spans=True):
    """One profiled round (times in µs): the route, the experts' forward, the
    combine, and the experts' backward launched from autograd's thread."""
    ev = [_span("hflbench.window", 0, 10000), _span("hfl.train_step", 100, 9000)]
    if with_moe_spans:
        ev += [_span("moe.route", 200, 500), _span("moe.experts", 800, 1000),
               _span("moe.combine", 1900, 300), _span("moe.experts.backward", 3000, 2000, tid=2)]
    ev += _op(1, 300, 310, 100) + _op(2, 900, 910, 600) + _op(3, 2000, 2010, 150)
    ev += _op(4, 3100, 3110, 1200, launch_tid=2)
    cfg = overlay(load_json("configs", "deepseek-v2-lite"), False)
    traffic = overlay(load_json("traffic", "moe-train4k-h4"), False)
    info = {"rounds": 10, "trace_rounds": 1, "window_s": 1.0, "rows": 4, "seq": 4096,
            "tokens": 10 * 4 * 32768}
    return SimpleNamespace(trace=Trace(ev), info=info, config=cfg, traffic=traffic)


def _read(name, ctx):
    return load_module("metrics", name).read(ctx)


def test_moe_readers_on_a_synthetic_trace():
    ctx = _ctx()
    assert _read("moe_experts_ms.moe", ctx) == pytest.approx(1.8)  # 0.6 forward + 1.2 backward
    assert _read("moe_route_ms.moe", ctx) == pytest.approx(0.25)
    m = ctx.config["model"]
    # 4 steps x 2 clusters x 6 MoE layers x 16,384 tokens x 1.5 held slots, 12 products each
    flops = 8 * 6 * 16384 * 1.5 * 12 * 2 * 2048 * 1408
    assert my.held_slots_per_token(m) == 1.5 and my.moe_layers(m) == 6
    assert _read("grouped_mm_roofline.moe", ctx) == pytest.approx(100 * flops / 989e12 / 1.8e-3)


@pytest.mark.parametrize("name", MOE_METRICS)
def test_moe_readers_are_silent_without_the_layers_spans(name):
    assert _read(name, _ctx(with_moe_spans=False)) is None
    assert _read(name, SimpleNamespace(**{**vars(_ctx()), "trace": None})) is None


@pytest.mark.parametrize("name,kernels,per_entry", [
    ("update_max_roofline.moe", ("update_max_kernel",), 16),
    ("tail_hist_roofline.moe", ("slice_hist_kernel", "tile_order_sum_kernel"), 4),
])
def test_sync_kernel_readers_count_the_configurations_flat_row(name, kernels, per_entry):
    from hflbench.metrics import _yardstick as y

    ev = [_span("hflbench.window", 0, 10000)]
    for i, k in enumerate(kernels):  # two calls, 1 ms of device time each
        for c in range(2):
            corr = 10 * i + c
            ev += [{"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                    "ts": 100 + 3000 * c + 10 * i, "dur": 2, "tid": 1,
                    "args": {"correlation": corr}},
                   {"ph": "X", "cat": "kernel", "name": k, "ts": 200 + 3000 * c + 1000 * i,
                    "dur": 1000 // len(kernels), "tid": 7, "args": {"correlation": corr}}]
    ctx = SimpleNamespace(**{**vars(_ctx()), "trace": Trace(ev)})
    q = y.tiles(1151108608)  # the configuration's params: the port's flat row
    assert ctx.config["model"]["params"] == 1151108608
    extra = 4 * q // y.TILE if per_entry == 16 else 8 * y.BINS
    want = 100 * 2 * (per_entry * q + extra) / y.HBM / 2e-3
    assert _read(name, ctx) == pytest.approx(want)
    assert _read(name, _ctx()) is None  # no such kernel in the trace


def test_mfu_counts_the_published_shapes():
    m = overlay(load_json("configs", "deepseek-v2-lite"), False)["model"]
    d = 2048
    mla = d * 16 * 192 + d * 576 + 512 * 16 * 256 + 16 * 128 * d
    attn = 16 * 4096 * 320
    want = (7 * (2 * mla + attn) + 2 * 3 * d * 10944
            + 6 * 2 * (3 * d * 1408 * 3.5 + d * 64) + 2 * d * 12800)
    assert my.forward_flops_per_token(m, 4096) == pytest.approx(want)
