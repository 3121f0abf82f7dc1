"""One run of one cell: set-up, the measured window, the check, one result line.

The cell, its configuration, its traffic mix, its driver and its per-layer
metrics are all found by name: ``workloads/<cell>.json`` names a
``config`` (``configs/<config>.json``), a ``traffic`` mix
(``traffic/<traffic>.json``) and a ``driver`` (``drivers/<driver>.py``);
``BENCHMARK.json`` at the root of the checkout lists the metrics, and each
per-layer metric is read by ``metrics/<metric>.py``.  Adding any of them is
adding files and entries.
"""
from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import torch

from hflbench.profiling import HostLoad, peak_since_reset, print_memory

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(kind: str, name: str) -> dict:
    with open(HERE / kind / f"{name}.json") as fh:
        return json.load(fh)


def load_module(kind: str, name: str):
    path = HERE / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"hflbench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def overlay(base: dict, tiny: bool) -> dict:
    """A configuration or traffic mix as run: its ``tiny`` overrides applied
    for the CPU tests' size."""
    out = {k: v for k, v in base.items() if k != "tiny"}
    if tiny:
        for k, v in base.get("tiny", {}).items():
            out[k] = {**out[k], **v} if isinstance(v, dict) else v
    return out


def applies(metric: dict, cell: str, reported: set) -> bool:
    """A metric is read in the cells its ``workloads`` list, or without one
    in every cell that reports the end-to-end metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in reported


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def parse(argv):
    ap = argparse.ArgumentParser(prog="python3 hflbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--tiny", action="store_true",
                    help="the CPU tests' size: the configuration's and traffic's "
                         "tiny overrides, on the CPU")
    return ap.parse_args(argv)


def context(name: str, seed: int, device, tiny: bool = False, fault=None):
    """One run's context: the cell, its configuration and traffic mix as run,
    the seed, the device, and the fault planted in the timed path (only the
    check's tests and ``calibrate.py`` plant one).  Float32 products run at
    full precision from here on: TF32 off for matmuls and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    cell = load_json("workloads", name)
    return SimpleNamespace(
        name=name, cell=cell, seed=seed, device=device, tiny=tiny, fault=fault,
        config=overlay(load_json("configs", cell["config"]), tiny),
        traffic=overlay(load_json("traffic", cell["traffic"]), tiny))


def device_sync(device):
    return torch.cuda.synchronize if device.type == "cuda" else (lambda: None)


def free_device_memory(device):
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def run(argv, t_start: float) -> int:
    """The command: measure, refuse a process that loaded JAX or the JAX
    package, print each compared number beside its limit on stderr and the
    result as the last line of stdout."""
    line = measure(parse(argv), t_start)
    if line is None:
        return 3
    found = forbidden_modules()
    if found:
        print(f"hflbench: the run loaded {', '.join(found)}; no result", file=sys.stderr)
        return 4
    for name, c in line["compared"].items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(_finite(line), allow_nan=False))
    return 0


def measure(args, t_start: float, fault=None):
    """One run of ``args.workload``: -> the result line (a dict), or None
    when the machine lacks the devices the cell asks for.  ``fault`` plants
    one of the faults the check must catch (the tests of the check)."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = load_json("workloads", args.workload)
    if args.tiny:
        device = torch.device("cpu")
    else:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            print(f"hflbench: the cell needs {cell['chips']} CUDA device(s); "
                  f"available: {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return None
        device = torch.device("cuda", 0)
    ctx = context(args.workload, args.seed, device, args.tiny, fault)
    sync = device_sync(device)
    t_imported = time.perf_counter()
    if device.type == "cuda":
        torch.empty(0, device=device)  # the allocator exists before its peak is reset
        torch.cuda.reset_peak_memory_stats(device)
    t_context = time.perf_counter()
    driver = load_module("drivers", cell["driver"]).Driver(ctx, sync)
    driver.setup()
    sync()
    # what set-up made lives to the end of the run: the collector leaves it
    # alone, so its full collections in the window scan only the window's objects
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_start
    print(f"setup_s {setup_s:.3f}: imports {t_imported - t_start:.3f}, device context "
          f"{t_context - t_imported:.3f}, driver set-up {setup_s - (t_context - t_start):.3f}",
          file=sys.stderr)
    print_memory("after set-up", device)
    setup_peak = peak_since_reset(device)  # the window's own peak is read apart
    with HostLoad():
        win = driver.window(args.seconds, traced=bool(args.trace))
    print_memory("after the window", device)
    peak = max(setup_peak, peak_since_reset(device))
    gc.unfreeze()
    driver.release()
    free_device_memory(device)
    correct, compared = driver.check(cell.get("limits", {}))

    e2e = {"setup_s": setup_s, "peak_mem_gb": peak / 1e9, **win.end_to_end}
    reported = {m["name"] for m in bench["end_to_end"]
                if applies(m, args.workload, set(e2e)) and m["name"] in e2e}
    metrics = {}
    if args.trace:
        mctx = SimpleNamespace(trace=win.trace, spans=win.spans, info=win.info,
                               config=ctx.config, traffic=ctx.traffic)
        for m in bench["per_layer"]:
            if applies(m, args.workload, reported):
                value = load_module("metrics", m["name"]).read(mctx)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in bench["end_to_end"]:
            if m["name"] in reported:
                metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}

    if device.type == "cuda":
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
               "count": cell["chips"], "memory_peak_bytes": int(peak)}
    else:
        dev = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    line = {"correct": bool(correct), "attempted": win.attempted, "failed": win.failed,
            "metrics": metrics, "device": dev}
    if args.trace and win.trace is not None:
        dev["busy_s"] = win.trace.busy_s
        dev["window_s"] = win.trace.window_s
        line["breakdown"] = win.trace.breakdown()
    line["compared"] = compared
    return line


def _finite(x):
    """x with every non-finite float as null (JSON has no inf or NaN)."""
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_finite(v) for v in x]
    if isinstance(x, float) and not math.isfinite(x):
        return None
    return x
