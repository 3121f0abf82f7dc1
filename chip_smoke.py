#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU: the quickest proof that
the port starts and computes the right thing on the card.

    python3 chip_smoke.py                # from the root of a checkout

It takes no arguments. Each phase is a function ``phase(torch, card)``
whose docstring says what it checks; ``main`` runs them in this order, each
ending in ``torch.cuda.synchronize()``, and any failure exits nonzero:
  1.  ``setup``: the card, the build, each kernel's registers and spills,
      the bf16 attention kernels' SASS, the paths' sizes -> the ``Card``;
  2.  ``kernel_checks``: the sync kernels against their plain versions;
  3.  ``fused_selection``: the fused selection on a gaussian [2, Q];
  2d. ``radix_select_checks``: the exact top-k's radix select;
  2e. ``sgdm_checks``: SGDM's update;
  4.  ``main_path``: full-width olmo-1b through the train CLI;
  5.  ``faithful_path``: full-width ResNet-18 under ``FaithfulHFL``;
  6.  ``comm_path``: the comm layer on phase 5's sync state;
  7.  ``sim_path``: the simulator's nine runs at full olmo-1b width;
  8.  ``obs_path``: the obs flags, 8a against phase 7's paper-fig3 run;
  9.  ``model_families``: every architecture family;
  10. ``sharded_paths``: the sharded flat vector and the mesh syncs;
  12. ``checkpoint_and_dryrun``: checkpoints and the dry-run;
  13. ``long_context``: train_4k's and prefill_32k's lengths;
  14. ``long_decode``: decode at decode_32k's and long_500k's shapes;
  11. ``kernel_summary``: one JSON line listing every ported kernel.
The last line is ``{"ok": true, "device": {...}}``. Without a CUDA device,
or without the rest of the repository, it exits nonzero and prints no
result.

Any phase runs alone from a script under ``build/`` (ignored by git), run
from the root of the checkout:

    import sys; sys.path.insert(0, ".")
    import torch, chip_smoke as cs
    cs.alone(torch, cs.comm_path)

``alone`` sets up as phase 1 does, runs the phase (6 and 8, which read
phase 5's and 7's results, then make them themselves) and ends in the
summary of the kernels that phase launched. Each launch count is read
before and after its run (``LaunchCount``), so it does not depend on the
phases run before. Phases 2, 3 and 6 draw their random data from the
card's one generator, so run alone they draw other numbers than in a
whole run.
"""
import dataclasses
import gc
import hashlib
import importlib.util
import itertools
import json
import math
import os
import re
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np

os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# the port, from this checkout (it imports torch, after the allocator's setting)
from repro_torch.checkpoint import msgpack_ckpt as ck  # noqa: E402
from repro_torch.comm import accounting as acc, codecs as cod  # noqa: E402
from repro_torch.configs import (  # noqa: E402
    ARCHS, HFLConfig, get_config, get_shape, parse_tiers_spec)
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.configs.resnet18_cifar import CONFIG as PAPER  # noqa: E402
from repro_torch.core import hfl as H, sparsify as sp  # noqa: E402
from repro_torch.core.hfl import HFLState  # noqa: E402
from repro_torch.data import SyntheticImages  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.bitpack import kernel as BK, ops as bops  # noqa: E402
from repro_torch.kernels.decode_attn import kernel as DA  # noqa: E402
from repro_torch.kernels.decode_attn.ref import NEG_INF, valid_slots  # noqa: E402
from repro_torch.kernels.dgc import kernel as DK, ops as dops  # noqa: E402
from repro_torch.kernels.flash_attn import kernel as FA  # noqa: E402
from repro_torch.kernels.fused_sync import kernel as FK, ops as fops  # noqa: E402
from repro_torch.kernels.radix_select import kernel as RS  # noqa: E402
from repro_torch.kernels.sgdm import kernel as SK  # noqa: E402
from repro_torch.launch import (  # noqa: E402
    comm_bits, dryrun as D, mesh as M, noniid_hfl, paper_accuracy as pa,
    serve_batched, steps as st, train)
from repro_torch.launch.steps import build_decode_step, make_loss_fn  # noqa: E402
from repro_torch.launch.train import EVAL_CHUNK_TOKENS  # noqa: E402
from repro_torch.models.frontends import fake_frontend_embeds  # noqa: E402
from repro_torch.models.resnet import init_resnet18  # noqa: E402
from repro_torch.models.transformer import (  # noqa: E402
    decode_step, forward, init_cache, init_model, num_shared_attn_sites, prefill)
from repro_torch.obs import (  # noqa: E402
    MetricsRegistry, SpanTracer, torchprof, use_registry, validate_runlog,
    validate_trace)
from repro_torch.obs.health.monitor import HealthMonitor  # noqa: E402
from repro_torch.obs.spans import use_tracer  # noqa: E402
from repro_torch.optim import SGDM  # noqa: E402
from repro_torch.sim import engine as E  # noqa: E402
from repro_torch.sim.scenarios import apply_hfl_overrides, get_scenario  # noqa: E402
from repro_torch.utils import flatten as fl  # noqa: E402
from repro_torch.utils.tree import (  # noqa: E402
    jax_leaves, tree_flatten, tree_leaves, tree_map, tree_unflatten)

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
F32_FLOPS = 67e12          # H100 SXM float32 outside the tensor cores
N_CLUSTERS, STEPS, PERIOD = 2, 4, 2
# kernel functions of csrc/*.cu, as the build log names them
KERNEL_FUNCTIONS = ("select_kernel", "update_max_kernel", "slice_hist_kernel",
                    "tile_order_sum_kernel", "apply_mask_kernel", "bitpack_kernel",
                    "fwd_kernel", "dq_kernel", "dkv_kernel", "fwd_wgmma_kernel",
                    "dq_wgmma_kernel", "dkv_wgmma_kernel", "decode_split_kernel",
                    "decode_merge_kernel", "gqa_decode_wgmma_kernel",
                    "mla_decode_wgmma_kernel", "radix_hist_kernel",
                    "tile_count_kernel", "tile_scan_kernel", "tile_write_kernel",
                    "sgdm_kernel")
# the bf16 decode kernels of csrc/decode_attn_sm90.cu: <DP> or <NB>
DECODE_TC_KERNELS = ("gqa_decode_wgmma_kernel", "mla_decode_wgmma_kernel")
# the bf16 attention kernels (csrc/flash_attn{,_bwd}.cu, decode_attn_sm90.cu):
# tensor cores and TMA
ATTN_TC_KERNELS = ("fwd_wgmma_kernel", "dq_wgmma_kernel",
                   "dkv_wgmma_kernel") + DECODE_TC_KERNELS
# block_select's spans (csrc/fused_sync.cu): a warp's and a CTA's share of a tile
SELECT_WARP_SPAN, SELECT_CTA_SPAN = 1024, 8192
# bitpack's design (csrc/bitpack.cu): CTAs per tile, elements per chunk
BP_CTAS, BP_CHUNK = 8, 4096
F_STEPS, F_LR = 8, 0.05  # the paper-exact path: 2 syncs, the example's lr
NONIID_STEPS = 4  # the non-IID twin: one sync per split at H = 4
FIG3_LAYERS = 6  # paper-fig3's depth cut: 7 clusters' state at full width
# scale-1m's depth cut: 7 clusters' async state (e_dl included) and the
# masked-step check's copies of the 6 idle rows pass the card at 6 layers
SCALE_LAYERS = 4
TRACE_SEED = 25  # trace-replay: an MU re-associates within the 4 steps
# the depth-3 runs' depth cut: 4 clusters' state plus the tier buffers (24
# B/param) and the probe's two scratch rows; 4 layers (6 until phase 14
# took the whole script past 1,000 s)
HIER_LAYERS = 4
HIER_DEADLINE_SEED = 0  # hier-deadline: the deadline drops an MU in both rounds
ASYNC_ROOT = "2x2x4:H=2,2:async"  # the scenario-free async-root tree
PEAK_LIMIT_GB = 76.0
# the telemetry runs' --metrics-out / --trace-viz files (build/ is ignored)
OBS_DIR = ROOT / "build" / "chip_smoke_obs"
OBS_LAYERS = 4  # phases 8b/8c's depth cut (6 until phase 14 took the script past 1,000 s)
# phase 9a: the serving twin at full width with the example's defaults; the
# depth cut of each configuration whose weights alone would take most of
# the card (or more): granite and llava ~0.38-0.56B params a layer, dbrx
# ~3.26B and deepseek-v2 ~3.97B
SERVE_LAYERS = {"granite-34b": 16, "llava-next-34b": 16, "dbrx-132b": 2,
                "deepseek-v2-236b": 2}
# 9b: decode == forward at full width in f32: arch -> (layers, prompt);
# mamba2's prompt crosses its 256-token SSD chunk, zamba2's 7 layers hold
# shared-attention sites at layers 0 and 6
CACHE_RUNS = {"h2o-danube-3-4b": (2, 12), "deepseek-v2-236b": (2, 12),
              "dbrx-132b": (2, 12), "mamba2-780m": (2, 300),
              "zamba2-7b": (7, 12), "llava-next-34b": (2, 12)}
CACHE_STEPS, CACHE_TOL = 3, 2e-3  # the reference's test_decode_matches_forward
# 9c: HFL training on the new families: (arch, argv, Ω impl). Full-width
# MoE training waits for ROADMAP Queue 1 item 16 part 3 and four cards (one
# deepseek-v2 layer is ~3.97B params, ~200 GB of HFL state at N = 2), so
# deepseek-v2 trains reduced, in f32, held against the same run on the CPU
FAMILY_TRAIN = (("mamba2-780m", ["--full"], "pallas"),
                ("zamba2-7b", ["--full", "--layers", "7"], "fused"),
                ("musicgen-medium", ["--full", "--layers", "16"], "pallas"),
                ("deepseek-v2-236b", [], "pallas"))
# the kernels each Ω route of the LM paths launches, once a selected row
IMPL_KERNELS = {"fused": ("block_select",), "pallas": ("update_max", "tail_hist")}
MAIN_ARGV = ["--full", "--tiers", f"{N_CLUSTERS}x2:H={PERIOD}", "--sync", "sparse",
             "--batch-per-mu", "4", "--seq", "128", "--steps", str(STEPS),
             "--log-every", "1", "--device", "cuda"]


def emit(obj):
    print(json.dumps(obj), flush=True)


def bound_ms(nbytes, nops=0.0):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def cuda_ms(torch, fn, reps):
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def cuda_ms_cold(torch, fn, reps, flush, dirty=True):
    """Mean ms of ``fn`` with the L2 cache flushed (``flush`` rewritten,
    128 MB) before every launch; only the launch lies between the events.
    A spin of ~0.1 ms after the flush keeps the card busy while the host
    enqueues the launch, so its host-side cost stays out of the time.
    ``dirty=False`` flushes by reading ``flush`` instead: the L2 then holds
    clean lines, and no write-back of the flush lands inside the launch."""
    fn()
    total = 0.0
    for _ in range(reps):
        if dirty:
            flush.zero_()
        else:
            flush.sum()
        torch.cuda._sleep(200_000)  # clock cycles
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        total += a.elapsed_time(b)
    return total / reps


def same(torch, got, want, what):
    """Fail unless the kernel's outputs equal the plain version's bitwise
    (NaN-free data; -0.0 == 0.0); returns the max abs difference, 0.0."""
    for g, w in zip(got, want):
        if g.shape != w.shape or g.dtype != w.dtype or not torch.equal(g, w):
            raise AssertionError(f"{what}: kernel and plain version differ")
    return 0.0


def same_bits(torch, got, want, what):
    """Fail unless the 4-byte outputs are equal as bit patterns (-0.0 and
    NaN payloads included); returns the max abs difference, 0.0."""
    for g, w in zip(got, want):
        if (g.shape != w.shape or g.dtype != w.dtype
                or not torch.equal(g.view(torch.int32), w.view(torch.int32))):
            raise AssertionError(f"{what}: kernel and plain version differ")
    return 0.0


def ptxas_report(log):
    """Per kernel of the build log (``nvcc -Xptxas -v``): registers, spill
    stores and loads (bytes), static shared memory (bytes)."""
    out, name = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            mangled = line.split("'")[1]
            name = next((k for k in KERNEL_FUNCTIONS if k in mangled), mangled)
            if "flash_attn" in mangled or name in DECODE_TC_KERNELS:  # an instantiation
                name = attn_instance(name, mangled)
            elif "decode_attn" in mangled:  # <type, heads a warp, chunks a lane>
                dt = "bf16" if "bfloat16" in mangled else "f32"
                name = f"decode_attn {name}<{','.join([dt] + re.findall(r'Li(\d+)E', mangled))}>"
        elif name and "spill stores" in line:
            nums = [int(w) for w in line.replace(",", " ").split() if w.isdigit()]
            out.setdefault(name, {}).update(stack_bytes=nums[0], spill_stores=nums[1],
                                            spill_loads=nums[2])
        elif name and "Used" in line and "registers" in line:
            words = line.replace(",", " ").split()
            entry = out.setdefault(name, {})
            entry["registers"] = int(words[words.index("registers") - 1])
            entry["smem_bytes"] = (int(words[words.index("smem") - 2])
                                   if "smem" in words else 0)
    return out


def attn_instance(name, mangled):
    """``flash_attn <kernel><type,widths>`` of an attention kernel's
    instantiation: the f32 (CUDA-core) kernels by their bucket, the bf16
    (tensor-core) ones by their padded head widths and tile."""
    args = re.findall(r"Li(\d+)E", mangled)
    if name in DECODE_TC_KERNELS:  # GQA <padded head width>, MLA <ckv's blocks>
        return f"decode_attn {name}<bf16,{args[0]}>"
    if name in ATTN_TC_KERNELS:  # <DKP, DVP, key or q tile>
        return f"flash_attn {name}<bf16,{args[0]}x{args[1]},{args[2]}>"
    return f"flash_attn {name}<f32,{args[0]}>"


def sass_counts(lib):
    """Per attention kernel instantiation of the built library: how many of
    its SASS instructions (``cuobjdump -sass``) are tensor-core products
    (HGMMA) and TMA loads (UTMALDG)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    attn = ("fwd_kernel", "dq_kernel", "dkv_kernel") + ATTN_TC_KERNELS
    out, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            k = next((k for k in KERNEL_FUNCTIONS if k in m.group(1)), None)
            name = attn_instance(k, m.group(1)) if k in attn else None
            if name:
                out[name] = {"HGMMA": 0, "UTMALDG": 0}
        elif name:
            for op in out[name]:
                if op in line:
                    out[name][op] += 1
    return out


def res_usage(lib):
    """Per attention kernel instantiation of the built library: its
    resources as ``cuobjdump -res-usage`` reads them from the binary
    (REG, STACK, LOCAL, SHARED, ... in registers and bytes). A spill lands
    in the stack frame, so STACK and LOCAL are 0 for a kernel that keeps
    everything in registers and shared memory."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-res-usage", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    attn = ("fwd_kernel", "dq_kernel", "dkv_kernel") + ATTN_TC_KERNELS
    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function (\S+?):?\s*$", line)
        if m:
            k = next((k for k in KERNEL_FUNCTIONS if k in m.group(1)), None)
            name = attn_instance(k, m.group(1)) if k in attn else None
        elif name and "REG:" in line:
            out[name] = {key: int(val) for key, val in re.findall(r"(\w+):(\d+)", line)}
            name = None
    return out


def kernel_split(torch, fn, reps, flush=None,
                 names=("slice_hist_kernel", "tile_order_sum_kernel")):
    """Mean device ms per call of each named kernel that ``fn`` launches,
    from a short torch.profiler capture (``flush`` rewritten before each
    call evicts the L2; its own kernel is not counted), and without a
    flush, of all its device work (``"all"``)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            if flush is not None:
                flush.zero_()
            fn()
        torch.cuda.synchronize()
    avg = prof.key_averages()
    key = "self_device_time_total"
    if not hasattr(next(iter(avg)), key):
        key = "self_cuda_time_total"
    out = {k: sum(getattr(e, key) for e in avg if k in e.key) / reps / 1e3
           for k in names}
    if flush is None:
        out["all"] = sum(getattr(e, key) for e in avg) / reps / 1e3
    return out


def fused_outcomes(reg):
    """(calls the block_select candidates answered, calls the exact fallback
    answered) of ``select_topk_rows``, from the registry's count."""
    c = reg.counter("fused.select_calls")
    return int(c.value(outcome="candidates")), int(c.value(outcome="fallback"))


def split_by_hop(outcomes, steps, n_mus, n_clusters, period):
    """Per hop, how many fused selections the candidates answered and how
    many the exact fallback did. A faithful step selects in a fixed order:
    one row per MU (uplink), one per cluster (SBS downlink) and, on a sync
    step, 2N + 1 more (N SBS uplinks, the MBS, N downlinks)."""
    hops = {h: {"kernel_pipeline": 0, "exact_fallback": 0}
            for h in ("mu_ul", "sbs_dl", "sync")}
    it = iter(outcomes)
    for t in range(steps):
        groups = [("mu_ul", n_mus), ("sbs_dl", n_clusters)]
        if (t + 1) % period == 0:
            groups.append(("sync", 2 * n_clusters + 1))
        for hop, n in groups:
            for ok in itertools.islice(it, n):
                hops[hop]["kernel_pipeline" if ok else "exact_fallback"] += 1
    return hops


def load_tool(name):
    """``tools/<name>.py`` of the checkout, loaded by path (stdlib only)."""
    spec = importlib.util.spec_from_file_location(f"_{name}",
                                                  ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def check_obs_outputs(name, args, out, eng):
    """A telemetry run's outputs: the ``--metrics-out`` JSONL schema-valid;
    the ``--trace-viz`` export valid and passing ``tools/trace_summary.py
    --check`` (span bits = the tracer's books = the ledger's, per link);
    the registry's launch and bit totals equal to the trace meta's and the
    ledger's. -> what the JSON line reports."""
    errs = validate_runlog(args.metrics_out)
    if errs:
        raise AssertionError(f"obs {name}: run log {errs[:3]}")
    kinds = {}
    for line in Path(args.metrics_out).read_text().splitlines():
        ev = json.loads(line)["event"]
        kinds[ev] = kinds.get(ev, 0) + 1
    info = {"events_by_kind": kinds}
    if args.trace_viz:
        obj = json.loads(Path(args.trace_viz).read_text())
        validate_trace(obj)
        if load_tool("trace_summary").main([args.trace_viz, "--check"]) != 0:
            raise AssertionError(f"obs {name}: trace_summary --check failed")
        info.update(trace_events=len(obj["traceEvents"]),
                    dropped=obj["metadata"]["dropped_events"],
                    link_bits=obj["metadata"]["link_bits"],
                    counter_tracks=sorted({e["name"] for e in obj["traceEvents"]
                                           if e.get("ph") == "C"}))
    snap = out["telemetry"].registry.snapshot()
    meta = out["trace"].meta
    for k in ("train_launches", "sync_launches"):
        if snap[f"sim.{k}"]["series"][""] != meta[k]:
            raise AssertionError(f"obs {name}: registry {k} != trace meta")
    if eng.ledger is not None:
        comm = snap["comm.bits"]["series"]
        for link, bits in eng.ledger.bits.items():
            if eng.ledger.events[link] and comm.get(f"link={link}") != bits:
                raise AssertionError(f"obs {name}: comm.bits {link} != ledger")
        info["comm_bits"] = comm
    return info


class method_timer:
    """Times every call of ``cls.name`` (the device waited on first, so a
    call's own host time is measured) into ``self.seconds`` while active."""

    def __init__(self, torch, cls, name):
        self.torch, self.cls, self.name, self.seconds = torch, cls, name, []

    def __enter__(self):
        inner, timer = getattr(self.cls, self.name), self
        self.inner = inner

        def timed(*args, **kwargs):
            timer.torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = inner(*args, **kwargs)
            timer.seconds.append(time.perf_counter() - t0)
            return out

        setattr(self.cls, self.name, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.cls, self.name, self.inner)
        return False


def free(torch):
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


class LaunchCount:
    """Each kernel wrapper's launches since this object was made (``fns``:
    name -> wrapper, whose ``launches`` attribute counts its kernel's
    launches): ``read()`` -> {name: launches since}. Nothing is zeroed, so
    what ran before does not show in a count."""

    def __init__(self, fns):
        self.fns = dict(fns)
        self.start = {k: fn.launches for k, fn in self.fns.items()}

    def read(self):
        return {k: fn.launches - self.start[k] for k, fn in self.fns.items()}


def sync_kernels():
    """The sync's kernels by name (their wrappers' ``launches`` counters)."""
    return {"block_select": FK.block_select, "update_max": DK.update_max,
            "tail_hist": DK.tail_hist, "apply_mask": DK.apply_mask,
            "bitpack": BK.bitpack}


def rows_identical(torch, state):
    """Whether every cluster's row of each param equals cluster 0's."""
    return all(torch.equal(P[0], P[n]) for P in tree_leaves(state.params)
               for n in range(1, P.shape[0]))


def model_families(torch, card):
    """Phase 9: every architecture family on the card. (a) The serving twin
    (``launch.serve_batched.run``, the example's batch 8, prompt 48 and 16
    new tokens, ``--full``, bf16) for all ten architectures, at full depth
    but for the depth cuts of ``SERVE_LAYERS``: finite logits, tokens [8,
    16], prefill ms, decode ms per step, the peak, one attention forward
    launch per attention site (``attn_sites``) and one decode kernel launch
    a site a decode step (``decode_attn``, deepseek-v2's
    ``mla_decode_attn``, each on the kernel its route picks;
    ``decode_launches_want``). (b) Decode == forward at full width in f32
    (``CACHE_RUNS``): prefill with ``max_len`` = prompt + frontend + 3, three
    decode steps against the full-sequence logits at rtol/atol 2e-3 (two
    attention forward launches a site: the forward and the prefill; three
    decode launches a site); and every reduced configuration's forward card
    = CPU in f32 at 1e-4. (c) HFL training through ``train.run`` at
    ``2x2:H=2 --sync sparse --batch-per-mu 4 --seq 128``, 4 steps
    (``FAMILY_TRAIN``), deepseek-v2's losses equal to the same run on the
    CPU at rtol 1e-4; full-width MoE training waits for ROADMAP
    Queue 1 item 16 part 3, a machine with four cards (one deepseek-v2
    layer is ~3.97B params, ~200 GB of HFL state at N = 2). Each run: 6
    launches of each kernel of its impl, the attention launches the path
    implies (``train_attn_want``), every leaf's SGDM update on the kernel
    (one launch a leaf a cluster a step), the rows identical after each
    sync, finite losses, sync ms and a peak under ``PEAK_LIMIT_GB``. Adds
    each run's kernel launches to ``card.by_path``."""
    dev = torch.device("cuda")
    t9 = time.perf_counter()
    limit = PEAK_LIMIT_GB * 1e9
    attn, by_path, smi = attn_kernels(), card.by_path, card.smi

    def attn_check(what, since, forwards, decodes, cfg):
        """The attention launches since ``since`` was made: ``forwards``
        no-grad forwards of ``cfg`` launch the forward kernel at each
        attention site, ``decodes`` decode steps the decode kernel at each,
        and nothing launches the backward."""
        torch.cuda.synchronize()
        got = since.read()
        want = {"flash_attn_fwd": forwards * attn_sites(cfg), "flash_attn_bwd": 0,
                **decode_launches_want(cfg, decodes)}
        if got != want:
            raise AssertionError(f"{what}: attention launches {got}, want {want}")
        return got

    # 9a. the serving twin, the example's defaults, --full
    for arch in sorted(ARCHS):
        free(torch)
        since = LaunchCount(attn)
        out = serve_batched.run(arch, batch=8, prompt_len=48, new_tokens=16,
                                device="cuda", full=True,
                                layers=SERVE_LAYERS.get(arch))
        # one prefill, then new_tokens - 1 decode steps against the cache
        launches = attn_check(f"serve {arch}", since, 1, 15, dataclasses.replace(
            get_config(arch), num_layers=out["layers"]))
        by_path[f"{arch} serve"] = launches
        finite = bool(torch.isfinite(out["logits"][..., :get_config(arch).vocab_size]
                                     .float()).all())
        emit({"phase": "families_serve", "arch": arch, "layers": out["layers"],
              "of_layers": get_config(arch).num_layers, "batch": 8,
              "prompt": 48, "new_tokens": 16,
              "prefill_ms": 1e3 * out["prefill_s"],
              "decode_ms_per_step": out["decode_ms_per_step"],
              "tokens_shape": list(out["tokens"].shape), "finite_logits": finite,
              "launches": launches, "peak_gb": out["peak_gb"], "card": smi})
        if not finite or tuple(out["tokens"].shape) != (8, 16):
            raise AssertionError(f"serve {arch}: non-finite logits or bad tokens")
        if out["peak_gb"] * 1e9 >= limit:
            raise AssertionError(f"serve {arch}: peak {out['peak_gb']:.1f} GB")
        del out

    # 9b. decode == forward at full width, f32 model math
    for arch, (layers, T) in CACHE_RUNS.items():
        cfg = dataclasses.replace(get_config(arch), num_layers=layers,
                                  dtype="float32")
        if cfg.num_experts:
            # no token dropped by any routing: the reference test's 8.0, or
            # E / K where that is larger (then C >= the group's tokens);
            # deepseek-v2's 160 experts top-6 give C = 8 for a 24-token
            # prefill at 8.0, and its tokens pick alike experts (up to 7 of
            # 24 in one on the CPU's weights), so 8.0 could drop there
            cfg = dataclasses.replace(cfg, capacity_factor=max(
                8.0, cfg.num_experts / cfg.experts_per_token))
        F = cfg.frontend_tokens if cfg.frontend != "none" else 0
        V = cfg.vocab_size
        free(torch)
        torch.cuda.reset_peak_memory_stats()
        params = init_model(torch.Generator(device=dev).manual_seed(0), cfg,
                            device=dev)
        toks = torch.randint(0, V, (2, T + CACHE_STEPS),
                             generator=torch.Generator().manual_seed(3)).to(dev)
        fe = (fake_frontend_embeds(torch.Generator().manual_seed(4), cfg, 2).to(dev)
              if F else None)
        errs = []
        since = LaunchCount(attn)
        with torch.no_grad():
            full, _ = forward(params, toks, cfg, frontend_embeds=fe)
            _, cache = prefill(params, toks[:, :T], cfg, frontend_embeds=fe,
                               max_len=T + F + CACHE_STEPS)
            for s in range(CACHE_STEPS):
                dl, cache = decode_step(params, cache, toks[:, T + s:T + s + 1], cfg)
                got, want = dl[:, 0, :V], full[:, F + T + s, :V]
                errs.append(float((got - want).abs().max()))
                if not torch.allclose(got, want, rtol=CACHE_TOL, atol=CACHE_TOL):
                    raise AssertionError(f"cache {arch}: decode step {s} differs "
                                         f"from forward by {errs[-1]}")
        # the forward and the prefill; the decode steps
        launches = attn_check(f"cache {arch}", since, 2, CACHE_STEPS, cfg)
        by_path[f"{arch} decode == forward"] = launches
        peak = torch.cuda.max_memory_allocated()
        emit({"phase": "families_cache", "arch": arch, "layers": layers,
              "prompt": T, "frontend_tokens": F, "steps": CACHE_STEPS,
              "dtype": "float32", "capacity_factor": cfg.capacity_factor,
              "max_abs_err_by_step": errs, "tol": CACHE_TOL, "launches": launches,
              "peak_gb": peak / 1e9, "card": smi})
        if peak >= limit:
            raise AssertionError(f"cache {arch}: peak {peak / 1e9:.1f} GB")
        del params, full, cache, dl

    # the reduced configs' forward: card = CPU, f32
    fwd_err = {}
    for arch in sorted(ARCHS):
        cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
        cpu_p = init_model(torch.Generator().manual_seed(0), cfg, device="cpu")
        toks = torch.randint(0, cfg.vocab_size, (2, 16),
                             generator=torch.Generator().manual_seed(5))
        fe = (fake_frontend_embeds(torch.Generator().manual_seed(6), cfg, 2)
              if cfg.frontend != "none" else None)
        with torch.no_grad():
            want, want_aux = forward(cpu_p, toks, cfg, frontend_embeds=fe)
            got, got_aux = forward(tree_map(lambda a: a.to(dev), cpu_p), toks.to(dev),
                                   cfg, frontend_embeds=None if fe is None
                                   else fe.to(dev))
        V = cfg.vocab_size
        got, want = got[..., :V].cpu(), want[..., :V]
        fwd_err[arch] = float((got - want).abs().max())
        if not (torch.allclose(got, want, rtol=1e-4, atol=1e-4) and torch.allclose(
                got_aux.cpu(), want_aux, rtol=1e-4, atol=1e-4)):
            raise AssertionError(f"reduced {arch}: card and CPU forward differ "
                                 f"by {fwd_err[arch]}")
    emit({"phase": "families_card_equals_cpu", "dtype": "float32",
          "max_abs_err": fwd_err, "tol": 1e-4})

    # 9c. HFL training on the new families through train.run
    want_launches = (N_CLUSTERS + 1) * (STEPS // PERIOD)
    counted = {**sync_kernels(), **attn, "sgdm": SK.sgdm_update}
    real_get_config, real_init = train.get_config, train.init_model
    for arch, extra, impl in FAMILY_TRAIN:
        argv = (MAIN_ARGV[1:] + ["--arch", arch, "--omega-impl", impl] + extra)
        identical, q, n_leaves = [], [], []

        def on_sync(i, st, sec):
            q[:] = [sum(P[0].numel() for P in tree_leaves(st.params))]
            n_leaves[:] = [len(tree_leaves(st.params)),
                           sum(1 for P in tree_leaves(st.params) if P[0].numel())]
            identical.append(rows_identical(torch, st))

        f32 = arch == "deepseek-v2-236b"
        if f32:  # held against the CPU at the f32 tolerance, from one init
            # (a CUDA generator draws other numbers than the CPU's)
            train.get_config = lambda n: dataclasses.replace(
                real_get_config(n), dtype="float32")
            train.init_model = lambda gen, cfg, device=None: tree_map(
                lambda a: a.to(device), real_init(
                    torch.Generator().manual_seed(0), cfg, device="cpu"))
        try:
            free(torch)
            torch.cuda.reset_peak_memory_stats()
            since = LaunchCount(counted)
            with use_registry(MetricsRegistry()) as reg:
                out = train.run(train.parse_args(argv), on_sync=on_sync)
                torch.cuda.synchronize()
            launches = since.read()
            sgdm = reg.counter("optim.sgdm_leaves")
            sgdm_leaves = {"kernel": sgdm.value(route="kernel"),
                           "plain": sgdm.value(route="plain")}
            peak = torch.cuda.max_memory_allocated()
            cpu = None
            if f32:
                cpu = train.run(train.parse_args(
                    [a if a != "cuda" else "cpu" for a in argv]))
        finally:
            train.get_config, train.init_model = real_get_config, real_init
        by_path[f"{arch} {impl}"] = launches
        line = {"phase": "families_train", "arch": arch, "argv": argv,
                "impl": impl, "Q": q[0], "losses": out["hist"],
                "eval_loss": out["eval_loss"],
                "first_step_s": out["timing"]["compile_s"],
                "sync_ms": [1e3 * t for t in out["sync_s"]],
                "max_memory_allocated_gb": peak / 1e9, "launches": launches,
                "sgdm_leaves_by_route": sgdm_leaves,
                "rows_identical_after_sync": identical, "card": smi}
        if cpu is not None:
            line.update(dtype="float32", cpu_losses=cpu["hist"],
                        cpu_eval_loss=cpu["eval_loss"])
        emit(line)
        for name in IMPL_KERNELS[impl]:
            if launches[name] != want_launches:
                raise AssertionError(f"train {arch}: {name} launched "
                                     f"{launches[name]} times, want {want_launches}")
        want_attn = train_attn_want(argv)
        if {k: launches[k] for k in want_attn} != want_attn:
            raise AssertionError(f"train {arch}: attention launches {launches}, "
                                 f"want {want_attn}")
        # SGDM: every leaf of every cluster's step on the kernel, bf16 and f32
        want_sgdm = (n_leaves[0] * N_CLUSTERS * STEPS, 0, n_leaves[1] * N_CLUSTERS * STEPS)
        if (sgdm_leaves["kernel"], sgdm_leaves["plain"], launches["sgdm"]) != want_sgdm:
            raise AssertionError(f"train {arch}: SGDM's leaves by route {sgdm_leaves}, "
                                 f"{launches['sgdm']} launches, want {want_sgdm}")
        if not (len(identical) == STEPS // PERIOD and all(identical)):
            raise AssertionError(f"train {arch}: cluster rows differ after a sync")
        if not (math.isfinite(out["eval_loss"])
                and all(math.isfinite(l) for l in out["hist"])):
            raise AssertionError(f"train {arch}: non-finite loss")
        if peak >= limit:
            raise AssertionError(f"train {arch}: peak {peak / 1e9:.1f} GB")
        if cpu is not None:
            got = out["hist"] + [out["eval_loss"]]
            want = cpu["hist"] + [cpu["eval_loss"]]
            if not all(math.isclose(g, w, rel_tol=1e-4) for g, w in zip(got, want)):
                raise AssertionError(f"train {arch}: card losses {got} != CPU {want}")
        del out, cpu
    emit({"phase": "families_done", "seconds": time.perf_counter() - t9})
    free(torch)


# ---- phase 10: the sharded flat vector and the mesh syncs ----------------
SHARDS = 4  # 10a/10b: the flat vector in 4 pieces, (data, model) = (2, 2)
# 10c's depth cut: 8 rank processes, their contexts and blocks share the card
# (4 layers until phase 14 took the whole script past 1,000 s)
POD_LAYERS = 2
CHUNK = 1 << 22  # 10b's seeded chunks and the fingerprints' chunk
RANK_TIMEOUT_S = 300
_H = -7046029254386353131  # 0x9E3779B97F4A7C15 as int64: the position hash


def fingerprint(torch, t, offset=0):
    """Σ_i (bits(t[i]) + c)·h(offset + i) mod 2^64 over the flat tensor, in
    int64 arithmetic that wraps: equal bit patterns at equal positions give
    equal sums whatever the order of summation, so pieces add up to the
    whole; a difference in any one entry always changes it."""
    bits = {4: torch.int32, 2: torch.int16}[t.element_size()]
    x = t.reshape(-1)
    total = 0
    for a in range(0, x.numel(), CHUNK):
        k = x[a:a + CHUNK].view(bits).long()
        pos = torch.arange(offset + a, offset + a + k.numel(), device=t.device)
        total += int(((k + 0x5BD1E995) * ((pos * _H) | 1)).sum())
    return total % (1 << 64)


def seeded_vector(torch, seed, lo, hi, total, device, scale=1.0):
    """Entries [lo, hi) of a vector of ``total`` entries (zeros past it)
    made from fixed chunks of CHUNK normals, chunk c from seed (seed, c):
    any process builds any piece of the same whole vector."""
    out = torch.zeros((hi - lo,), dtype=torch.float32, device=device)
    for c in range(lo // CHUNK, (min(hi, total) - 1) // CHUNK + 1):
        g = torch.Generator(device=device).manual_seed(seed * 1_000_003 + c)
        v = torch.randn((CHUNK,), generator=g, device=device)
        a, b = max(lo, c * CHUNK), min(hi, total, (c + 1) * CHUNK)
        out[a - lo:b - lo] = v[a - c * CHUNK:b - c * CHUNK] * scale
    return out


def seeded_flat_shard(torch, spec, shard, N, device):
    """The FlatShard of piece ``shard`` (None: the whole padded vector) of
    a seeded sync state: params 0.02·randn per cluster (each entry rounded
    to its leaf's dtype), w_ref 0.02·randn, eps and e 0.001·randn."""
    sl = slice(0, spec.padded_total) if shard is None else spec.shard_slice(shard)
    vec = lambda seed, sc: seeded_vector(torch, seed, sl.start, sl.stop,
                                         spec.total, device, sc)
    params = H.round_to_leaf_dtypes_(torch.stack([vec(10 + n, 0.02) for n in range(N)]),
                                     spec, sl.start)
    return H.FlatShard(
        params=params.to(H.flat_params_dtype(spec)),
        w_ref=vec(1, 0.02), eps=torch.stack([vec(20 + n, 1e-3) for n in range(N)]),
        e=vec(2, 1e-3), spec=spec, shard=shard)


def shard_fingerprints(torch, fs):
    """Each field's (per-row) fingerprints of a FlatShard, positions global;
    params as f32 (exact), so any storage dtype of them compares."""
    off = fs.offset
    return {f: ([fingerprint(torch, r.float(), off) for r in getattr(fs, f)]
                if getattr(fs, f).dim() == 2 else fingerprint(torch, getattr(fs, f), off))
            for f in ("params", "w_ref", "eps", "e")}


def state_fingerprints(torch, state, spec):
    """Per-row fingerprints of an HFLState's params (as f32) and eps, and
    of w_ref and e, over the model's Q entries (padding excluded); the
    buffers are the flat ones behind the trees (``spec``'s layout)."""
    Q, N = spec.total, tree_leaves(state.params)[0].shape[0]
    w, e = fl.backing(state.w_ref, spec), fl.backing(state.e, spec)
    eps = fl.backing(state.eps, spec, rows=N)
    rows = lambda n: sum(fingerprint(torch, P[n].float(), off) for P, off in zip(
        tree_leaves(state.params), spec.offsets)) % (1 << 64)
    return {"params": [rows(n) for n in range(N)], "w_ref": fingerprint(torch, w[:Q]),
            "eps": [fingerprint(torch, r[:Q]) for r in eps],
            "e": fingerprint(torch, e[:Q])}


def sharded_hfl(impl="fused", layout="flat", shards=1):
    """The main path's HFL configuration (2 clusters x 2 MUs, H = 2)."""
    return HFLConfig(tiers=parse_tiers_spec(f"{N_CLUSTERS}x2:H={PERIOD}"),
                     sync_mode="sparse", omega_impl=impl, sync_layout=layout,
                     flat_shards=shards)


def olmo_config(layers=None, reduced=False):
    cfg = get_config("olmo-1b")
    cfg = cfg.reduced() if reduced else cfg
    return cfg if layers is None else dataclasses.replace(cfg, num_layers=layers)


def olmo_flat_spec(torch, shards, reduced=False):
    """olmo-1b's padded flat layout (shapes only) in ``shards`` pieces."""
    return fl.spec_of(init_model(None, olmo_config(reduced=reduced), device="meta"),
                      shards=shards)


def rank_sharded(rank, world, device="cuda", reduced=False):
    """10b, one rank of (data, model) = (2, 2): its piece of the seeded
    state, one mesh-sharded sync; -> its fingerprints, launches, seconds."""
    import torch
    import torch.distributed as dist


    mesh = M.make_host_mesh(data=2, model=2)
    spec = olmo_flat_spec(torch, SHARDS, reduced)
    sh = M.shard_index(mesh, ("data", "model"))
    fs = seeded_flat_shard(torch, spec, sh, N_CLUSTERS, device)
    sync = H.make_sync(H.SyncPlan(sharded_hfl(), mesh=mesh))
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    since = LaunchCount({"block_select": FK.block_select})
    second0 = fops.shard_select_candidates.second_launches
    t0 = time.perf_counter()
    fs = sync(fs)
    if device == "cuda":
        torch.cuda.synchronize()
    return {"coord": M.mesh_coord(mesh), "shard": sh, "backend": dist.get_backend(),
            "sync_s": time.perf_counter() - t0,
            "block_select_launches": since.read()["block_select"],
            "second_launches": fops.shard_select_candidates.second_launches - second0,
            "certificates": sync.certificates, "fingerprints": shard_fingerprints(torch, fs),
            "max_memory_allocated_gb": (torch.cuda.max_memory_allocated() / 1e9
                                        if device == "cuda" else None)}


def pod_rank_state(torch, cfg, coord, shape, device, seed):
    """10c: the rank's blocks of a seeded pod-mesh state, built leaf by leaf
    (no rank holds a whole cluster): params = init + 0.01·randn for the
    rank's cluster, w_ref = init, eps = e = 0 (the reference test's first
    sync); -> (rank HFLState, pspecs)."""
    from repro_torch.launch.sharding import P, param_specs, rank_block

    params = init_model(torch.Generator(device=device).manual_seed(seed), cfg,
                        device=device)
    pspecs = param_specs(params, data=shape["data"], model=shape["model"])
    leaves, treedef = tree_flatten(params)
    c = coord["pod"]
    rows, refs = [], []
    for i, (x, spec) in enumerate(zip(leaves, tree_flatten(pspecs)[0])):
        g = torch.Generator(device=device).manual_seed(seed * 7919 + 31 * i + c)
        row = (x.float() + 0.01 * torch.randn(x.shape, generator=g, device=device))
        rows.append(rank_block(row.to(x.dtype)[None], P(None, *spec), shape, coord))
        refs.append(rank_block(x.float(), spec, shape, coord))
        del row
    del params, leaves
    un = lambda ls: tree_unflatten(treedef, ls)
    return HFLState(params=un(rows), opt=None, w_ref=un(refs),
                    eps=un([torch.zeros_like(r, dtype=torch.float32) for r in rows]),
                    e=un([torch.zeros_like(r) for r in refs]), step=0), pspecs


def pod_invariants(torch, mesh, before, after):
    """The reference test's invariants on this rank's blocks, from zero
    buffers: consensus (the pod peers' params equal), adoption (params =
    w_ref cast to their dtype) and conservation (applied + buffered = the
    mean drift, rtol 1e-4 / atol 1e-5); -> {name: bool}."""
    ok = {"consensus": True, "adoption": True, "conservation": True}
    for P0, W0, P1, W1, E1, e1 in zip(*(tree_leaves(t) for t in (
            before.params, before.w_ref, after.params, after.w_ref, after.eps,
            after.e))):
        peers = M.all_gather(P1, mesh, "pod")
        ok["consensus"] &= bool((peers == peers[0]).all())
        ok["adoption"] &= torch.equal(P1[0], W1.to(P1.dtype))
        old = M.all_gather(P0, mesh, "pod").float().mean(dim=(0, 1))
        eps = M.all_gather(E1, mesh, "pod").float().mean(dim=(0, 1))
        ok["conservation"] &= torch.allclose((W1 - W0) + eps + e1, old - W0,
                                             rtol=1e-4, atol=1e-5)
    return ok


def rank_pod(rank, world, device="cuda", layers=POD_LAYERS, reduced=False):
    """10c, one rank of (pod, data, model) = (2, 2, 2): the pod flat layout
    with ``pallas`` Ω and the leaf layout with ``topk`` on its blocks of
    olmo-1b at full width (``layers`` deep), with the invariants and launch
    counts; then both at the tests' narrow size on the card and on a CPU
    copy, which must agree bitwise."""
    import torch
    import torch.distributed as dist


    mesh = M.make_host_mesh(pods=2, data=2, model=2)
    shape, coord = M.mesh_shape(mesh), M.mesh_coord(mesh)
    counters = {fn.__name__: fn for fn in (DK.update_max, DK.tail_hist, DK.apply_mask,
                                           FK.block_select)}
    cfg = olmo_config(layers, reduced)
    narrow_cfg = ModelConfig(name="t", arch_type="dense", num_layers=2, d_model=32,
                             num_heads=4, num_kv_heads=2, d_ff=64, vocab_size=64,
                             dtype="float32", remat=False)
    runs = (("flat", "pallas"), ("leaf", "topk"))
    out = {"coord": coord, "backend": dist.get_backend(), "runs": {}}
    for layout, impl in runs:
        state, pspecs = pod_rank_state(torch, cfg, coord, shape, device, 0)
        before = state._replace(params=tree_map(torch.clone, state.params),
                                w_ref=tree_map(torch.clone, state.w_ref))
        sync = H.make_sync(H.SyncPlan(sharded_hfl(impl, layout), mesh=mesh,
                                      param_specs=pspecs))
        if device == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        since = LaunchCount(counters)
        t0 = time.perf_counter()
        state = sync(state)
        if device == "cuda":
            torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        out["runs"][f"{layout} {impl}"] = {
            "sync_s": secs, "Q_local": sum(x.numel() for x in tree_leaves(state.w_ref)),
            "launches": since.read(),
            "invariants": pod_invariants(torch, mesh, before, state),
            "max_memory_allocated_gb": (torch.cuda.max_memory_allocated() / 1e9
                                        if device == "cuda" else None)}
        del state, before
        if device == "cuda":
            torch.cuda.empty_cache()
    # the tests' narrow size: the card against a CPU copy, bit for bit
    equal = {}
    for layout, impl in runs:
        hfl = sharded_hfl(impl, layout)
        cpu_state, pspecs = pod_rank_state(torch, narrow_cfg, coord, shape, "cpu", 1)
        dev_state = cpu_state._replace(**{f: tree_map(lambda t: t.to(device),
                                                      getattr(cpu_state, f))
                                          for f in ("params", "w_ref", "eps", "e")})
        sync = H.make_sync(H.SyncPlan(hfl, mesh=mesh, param_specs=pspecs))
        dev_state, cpu_state = sync(dev_state), sync(cpu_state)
        equal[f"{layout} {impl}"] = all(  # bit patterns, signs of zeros too
            torch.equal(a.cpu().view(torch.uint8), b.view(torch.uint8))
            for f in ("params", "w_ref", "eps", "e")
            for a, b in zip(tree_leaves(getattr(dev_state, f)),
                            tree_leaves(getattr(cpu_state, f))))
    out["narrow_card_equals_cpu"] = equal
    return out


def sharded_paths(torch, card):
    """Phase 10, the sharded flat vector and the mesh syncs. (a) The main
    path's run with ``--flat-shards 4`` (full olmo-1b width and depth,
    ``fused`` Ω): S·(N + 1) = 12 ``block_select`` launches per sync plus the
    second launches it prints, the attention launches the path implies, the
    rows identical after each sync, each hop's exactness certificate
    printed; the last sync's input copied to the host (the copy's seconds
    are taken off its sync ms) and that sync run again with the plain
    compaction on the card, every output row equal bit for bit (64-bit
    position-weighted fingerprints of the bit patterns), and, where every
    certificate held, equal to the unsharded fused sync's. (b) 4 rank
    processes on the card, gloo, (data, model) = (2, 2), each building only
    its piece of a seeded state at olmo-1b's full Q (``seeded_flat_shard``):
    each piece's outputs equal the single-process emulation's on the same
    vectors, ``block_select`` 3 times per rank (+ second launches). (c) 8
    rank processes, gloo, (pod, data, model) = (2, 2, 2), the pod flat
    layout with ``pallas`` Ω and the leaf layout with ``topk`` on each
    rank's blocks of olmo-1b at full width and ``POD_LAYERS`` layers:
    consensus, conservation and adoption, 2 ``update_max`` and 2
    ``tail_hist`` launches per rank on the flat layout, and both layouts at
    the tests' narrow size card = CPU bit for bit; the ranks' logs land in
    ``build/chip_smoke_ranks/``. NCCL across cards waits for a machine with
    four cards. Adds each path's launches to ``card.by_path``."""
    dev = torch.device("cuda")
    t10 = time.perf_counter()
    limit = PEAK_LIMIT_GB * 1e9
    N, counters, by_path = N_CLUSTERS, sync_kernels(), card.by_path

    # 10a. the train CLI with --flat-shards 4 at full olmo-1b width and depth
    grab = {"post": [], "certs": []}
    real_make_sync = train.make_sync

    def capturing_make_sync(plan):
        sync = real_make_sync(plan)
        grab["sync"] = sync

        def wrapped(state):
            if len(grab["post"]) == STEPS // PERIOD - 1:  # the last sync's input
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                spec = fl.spec_of(state.w_ref, shards=SHARDS)
                bufs = [fl.backing(state.w_ref, spec), fl.backing(state.e, spec),
                        fl.backing(state.eps, spec, rows=N)]
                if any(b is None for b in bufs):
                    raise AssertionError("sharded: hfl_init's buffers are not "
                                         "the padded flat buffers")
                grab["pre"] = {"params": tree_map(lambda t: t.cpu(), state.params),
                               "w_ref": bufs[0].cpu(), "e": bufs[1].cpu(),
                               "eps": bufs[2].cpu(), "spec": spec}
                grab["capture_s"] = time.perf_counter() - t0
            return sync(state)

        return wrapped

    def on_sync(i, state, seconds):
        t0 = time.perf_counter()
        spec = fl.spec_of(state.w_ref, shards=SHARDS)
        grab["certs"].append(grab["sync"].certificates)
        grab["post"].append(state_fingerprints(torch, state, spec))
        grab.setdefault("identical", []).append(rows_identical(torch, state))
        grab["check_s"] = grab.get("check_s", 0.0) + time.perf_counter() - t0

    free(torch)
    torch.cuda.reset_peak_memory_stats()
    since = LaunchCount({**counters, **attn_kernels()})
    second0 = fops.shard_select_candidates.second_launches
    train.make_sync = capturing_make_sync
    argv = MAIN_ARGV + ["--omega-impl", "fused", "--flat-shards", str(SHARDS)]
    try:
        out = train.run(train.parse_args(argv), on_sync=on_sync)
    finally:
        train.make_sync = real_make_sync
    torch.cuda.synchronize()
    launches = since.read()
    peak = torch.cuda.max_memory_allocated()
    second = fops.shard_select_candidates.second_launches - second0
    syncs = STEPS // PERIOD
    want = SHARDS * (N + 1) * syncs + second
    by_path[f"olmo-1b fused flat_shards={SHARDS}"] = launches
    # the host copy is the check's: it is taken off the last sync's ms
    sync_ms = [1e3 * s for s in out["sync_s"]]
    sync_ms[-1] -= 1e3 * grab["capture_s"]
    emit({"phase": "sharded_one_process", "arch": "olmo-1b", "shards": SHARDS,
          "tiers": MAIN_ARGV[2], "steps": STEPS, "losses": out["hist"],
          "eval_loss": out["eval_loss"], "first_step_s": out["timing"]["compile_s"],
          "sync_ms": sync_ms,
          "host_copy_s": grab["capture_s"], "fingerprint_s": grab["check_s"],
          "max_memory_allocated_gb": peak / 1e9,
          "launches": launches, "second_block_select_launches": second,
          "certificates": grab["certs"], "rows_identical_after_sync": grab["identical"],
          "card": card.smi})
    if launches["block_select"] != want:
        raise AssertionError(f"sharded: block_select launched "
                             f"{launches['block_select']} times, want {want}")
    want_attn = train_attn_want(argv)
    if {k: launches[k] for k in want_attn} != want_attn:
        raise AssertionError(f"sharded: attention launches {launches}, want {want_attn}")
    if not (len(grab["identical"]) == syncs and all(grab["identical"])):
        raise AssertionError("sharded: cluster rows differ after a sync")
    if not (math.isfinite(out["eval_loss"]) and all(map(math.isfinite, out["hist"]))):
        raise AssertionError("sharded: non-finite loss")
    if peak >= limit:
        raise AssertionError(f"sharded: peak {peak / 1e9:.1f} GB")
    del out
    free(torch)

    def restore(pre, shards):
        """The captured state on the card, flat-backed in the padding of
        ``shards`` pieces (1: the unsharded layout)."""
        spec = pre["spec"] if shards > 1 else pre["spec"]._replace(shards=1, pad=0)
        n = spec.padded_total
        w, w_tree = fl.flat_backed_zeros(spec, None, torch.float32, dev)
        e, e_tree = fl.flat_backed_zeros(spec, None, torch.float32, dev)
        eps, eps_tree = fl.flat_backed_zeros(spec, N, torch.float32, dev)
        w.copy_(pre["w_ref"][:n])
        e.copy_(pre["e"][:n])
        eps.copy_(pre["eps"][:, :n])
        return H.HFLState(params=tree_map(lambda t: t.to(dev), pre["params"]),
                          opt=None, w_ref=w_tree, eps=eps_tree, e=e_tree, step=0), spec

    # the last sync again from its input, with the plain compaction on the
    # card: every output row bit for bit (the fingerprints)
    real_compact = fops._compact_kernel_prefix
    fops._compact_kernel_prefix = lambda S, th, cap: (
        *fops._compact_plain(S, th, cap)[:3], 0)
    try:
        since = LaunchCount({"block_select": FK.block_select})
        state, spec = restore(grab["pre"], SHARDS)
        sync = H.make_sync(H.SyncPlan(sharded_hfl(shards=SHARDS)))
        state = sync(state)
        torch.cuda.synchronize()
        plain_equal = state_fingerprints(torch, state, spec) == grab["post"][-1]
        plain_launches = since.read()["block_select"]
    finally:
        fops._compact_kernel_prefix = real_compact
    del state
    free(torch)
    held = all(grab["certs"][-1]["ul"]) and grab["certs"][-1]["dl"]
    unsharded_equal = None
    if held:  # the certificate held on every hop: the unsharded fused sync's
        state, spec = restore(grab["pre"], 1)
        state = H.make_sync(H.SyncPlan(sharded_hfl()))(state)
        torch.cuda.synchronize()
        unsharded_equal = state_fingerprints(torch, state, spec) == grab["post"][-1]
        del state
        free(torch)
    del grab["pre"]
    emit({"check": "sharded_rerun", "sync": syncs, "certificates": grab["certs"][-1],
          "plain_compaction_equal": plain_equal,
          "plain_compaction_block_select_launches": plain_launches,
          "unsharded_fused_equal": unsharded_equal})
    if not plain_equal or plain_launches:
        raise AssertionError("sharded: block_select's compaction and the plain "
                             "one differ on the card")
    if held and not unsharded_equal:
        raise AssertionError("sharded: the certificate held, but the state "
                             "differs from the unsharded fused sync's")

    # 10b. four gloo ranks on the card, (data, model) = (2, 2), full Q
    t0 = time.perf_counter()
    spec = olmo_flat_spec(torch, SHARDS)
    fs = seeded_flat_shard(torch, spec, None, N, dev)
    emu = H.make_sync(H.SyncPlan(sharded_hfl(shards=SHARDS)))
    fs = emu(fs)
    torch.cuda.synchronize()
    emu_s = time.perf_counter() - t0
    L, Q = spec.local_size, spec.total
    want_fp = [shard_fingerprints(torch, fs._replace(
        params=fs.params[:, sl], w_ref=fs.w_ref[sl], eps=fs.eps[:, sl], e=fs.e[sl],
        shard=sh)) for sh, sl in ((sh, spec.shard_slice(sh)) for sh in range(SHARDS))]
    whole_fp = shard_fingerprints(torch, fs._replace(
        params=fs.params[:, :Q], w_ref=fs.w_ref[:Q], eps=fs.eps[:, :Q], e=fs.e[:Q]))
    emu_certs = emu.certificates
    del fs
    free(torch)
    held = all(emu_certs["ul"]) and emu_certs["dl"]
    unsharded_equal = None
    if held:  # every certificate held: the unsharded fused sync's answer
        fs = seeded_flat_shard(torch, spec._replace(shards=1, pad=0), None, N, dev)
        state = H.HFLState(
            params=fl.unpack_stacked(fs.params, spec), opt=None,
            w_ref=fl.unpack(fs.w_ref, spec._replace(dtypes=(torch.float32,) * len(
                spec.dtypes), shards=1, pad=0)),
            eps=fl.unpack_stacked(fs.eps, spec._replace(dtypes=(torch.float32,) * len(
                spec.dtypes), shards=1, pad=0)),
            e=fl.unpack(fs.e, spec._replace(dtypes=(torch.float32,) * len(
                spec.dtypes), shards=1, pad=0)), step=0)
        del fs
        state = H.make_sync(H.SyncPlan(sharded_hfl()))(state)
        torch.cuda.synchronize()
        unsharded_equal = state_fingerprints(
            torch, state, spec._replace(shards=1, pad=0)) == whole_fp
        del state
        free(torch)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    ranks_dir = ROOT / "build" / "chip_smoke_ranks"
    t0 = time.perf_counter()
    infos = M.run_ranks(f"{ROOT / 'chip_smoke.py'}:rank_sharded", SHARDS, {},
                        ranks_dir / "10b", device="cuda", backend="gloo",
                        timeout_s=RANK_TIMEOUT_S, env=env)
    ranks_s = time.perf_counter() - t0
    for info in infos:
        emit({"phase": "sharded_mesh", "backend": info["backend"], "coord": info["coord"],
              "shard": info["shard"], "Q": spec.total, "local_size": L,
              "sync_s": info["sync_s"], "block_select_launches": info["block_select_launches"],
              "second_block_select_launches": info["second_launches"],
              "certificates": info["certificates"],
              "max_memory_allocated_gb": info["max_memory_allocated_gb"],
              "equals_emulation": info["fingerprints"] == want_fp[info["shard"]]})
        if info["fingerprints"] != want_fp[info["shard"]]:
            raise AssertionError(f"sharded mesh: shard {info['shard']} differs "
                                 "from the single-process emulation")
        if info["certificates"] != emu_certs:
            raise AssertionError("sharded mesh: certificates differ")
        if info["block_select_launches"] != (N + 1) + info["second_launches"]:
            raise AssertionError(f"sharded mesh: rank {info['coord']} launched "
                                 f"block_select {info['block_select_launches']} times")
    by_path["olmo-1b sharded mesh, 4 gloo ranks"] = dict(
        {k: 0 for k in counters},
        block_select=sum(i["block_select_launches"] for i in infos))
    emit({"phase": "sharded_mesh_done", "backend": "gloo", "ranks": SHARDS,
          "emulation_s": emu_s, "ranks_s": ranks_s, "certificates": emu_certs,
          "emulation_equals_unsharded_fused": unsharded_equal})
    if held and not unsharded_equal:
        raise AssertionError("sharded: the certificate held, but the emulation "
                             "differs from the unsharded fused sync")

    # 10c. eight gloo ranks, (pod, data, model) = (2, 2, 2)
    t0 = time.perf_counter()
    infos = M.run_ranks(f"{ROOT / 'chip_smoke.py'}:rank_pod", 8,
                        {"layers": POD_LAYERS}, ranks_dir / "10c", device="cuda",
                        backend="gloo", timeout_s=RANK_TIMEOUT_S, env=env)
    pod_want = {"flat pallas": {"update_max": 2, "tail_hist": 2},
                "leaf topk": {}}
    for info in infos:
        emit({"phase": "pod_mesh", "backend": info["backend"], "coord": info["coord"],
              "layers": POD_LAYERS, "runs": info["runs"],
              "narrow_card_equals_cpu": info["narrow_card_equals_cpu"]})
        for run, r in info["runs"].items():
            got = {k: v for k, v in r["launches"].items() if v}
            if got != pod_want[run]:
                raise AssertionError(f"pod mesh {run}: rank {info['coord']} "
                                     f"launched {got}, want {pod_want[run]}")
            if not all(r["invariants"].values()):
                raise AssertionError(f"pod mesh {run}: rank {info['coord']} "
                                     f"invariants {r['invariants']}")
        if not all(info["narrow_card_equals_cpu"].values()):
            raise AssertionError(f"pod mesh: rank {info['coord']}: the card and "
                                 f"the CPU differ {info['narrow_card_equals_cpu']}")
    for run in pod_want:
        by_path[f"olmo-1b pod mesh {run}, 8 gloo ranks"] = {
            k: sum(i["runs"][run]["launches"].get(k, 0) for i in infos)
            for k in counters}
        peaks = sum(i["runs"][run]["max_memory_allocated_gb"] for i in infos)
        if peaks * 1e9 >= limit:
            raise AssertionError(f"pod mesh {run}: the ranks' peaks add up to "
                                 f"{peaks:.1f} GB")
    emit({"phase": "pod_mesh_done", "backend": "gloo", "ranks": 8,
          "ranks_s": time.perf_counter() - t0})
    emit({"phase": "sharded_paths_done", "seconds": time.perf_counter() - t10})
    free(torch)


# ---- phase 12: checkpoints and the dry-run --------------------------------
# 12a's depth cut: 1 layer, ~5.6 GB a file at 2x2 (Q ~ 170M), 4 until
# phase 14 took the whole script past 1,000 s
CKPT_LAYERS = 1
CKPT_DIR = ROOT / "build" / "chip_smoke_ckpt"
CKPT_RUNS = (("fused", 1), ("pallas", 1), ("fused", SHARDS))
# the file's sha256 against the CPU encoder: once, on the padded layout (the
# encoder is the same code for every run; the states differ only in values)
CKPT_SHA_RUN = ("fused", SHARDS)


class _Sha256Sink:
    """A binary file object that only hashes what is written to it."""

    def __init__(self):
        self.h = hashlib.sha256()

    def write(self, b):
        self.h.update(b)
        return len(b)


def file_sha256(path):
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while chunk := f.read(1 << 26):
            h.update(chunk)
    return h.hexdigest()


def compare_file_with_cpu_encoder(path, saved):
    """The file's sha256 (in a thread: hashlib lets go of the GIL) against
    the CPU encoder's on a host copy of the saved state; raises when they
    differ -> the record of the comparison."""
    hashed = {}
    t0 = time.perf_counter()
    hasher = threading.Thread(target=lambda: hashed.update(
        sha=file_sha256(path), seconds=time.perf_counter() - t0))
    hasher.start()
    with HostRss() as rss:
        host = tree_map(lambda t: t.cpu(), tensors_of(saved))
        host["step"] = saved.step
        sink = _Sha256Sink()
        t1 = time.perf_counter()
        ck.write_payload(sink, host)
        encode_s = time.perf_counter() - t1
        del host
    hasher.join()
    if hashed["sha"] != sink.h.hexdigest():
        raise AssertionError(f"checkpoint {path.name}: the card's file and the CPU "
                             "encoder differ")
    return {"sha256": hashed["sha"], "sha256_cpu_encoder": sink.h.hexdigest(),
            "sha256_file_s": hashed["seconds"], "cpu_encode_s": encode_s,
            "host_rss_cpu_copy_and_encode": rss.report()}


def tensors_of(state):
    """An HFLState's fields but its int ``step``, as one dict tree."""
    return {k: v for k, v in state._asdict().items() if k != "step"}


def _rss_bytes():
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


class HostRss:
    """The process's resident set sampled every 5 ms while the block runs:
    ``start_gb`` and ``peak_gb`` (the process's lifetime peak would hold
    the earlier phases' host copies)."""

    def __enter__(self):
        self.start = self.peak = _rss_bytes()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._poll, daemon=True)
        self._thread.start()
        return self

    def _poll(self):
        while not self._stop.wait(0.005):
            self.peak = max(self.peak, _rss_bytes())

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, _rss_bytes())
        return False

    def report(self):
        return {"start_gb": self.start / 1e9, "peak_gb": self.peak / 1e9}


def checkpoint_and_dryrun(torch, card):
    """Phase 12. (b) The dry-run of olmo-1b x train_4k on both production
    meshes (``dryrun_pair``: ``meta`` tensors over a fake process group,
    nothing allocated), and its argument bytes of (a)'s state on a one-rank
    mesh against the growth of ``torch.cuda.memory_allocated`` across
    ``hfl_init`` on the card, within 512 B a leaf. (a) The train CLI with
    ``--ckpt-dir`` at full olmo-1b width and ``CKPT_LAYERS`` layers,
    ``2x2:H=2``, 4 steps, with ``fused``, ``pallas`` and ``fused
    --flat-shards 4``: the file (~5.6 GB) restored into a fresh card state
    (every leaf bit for bit, written in place into the flat buffers the
    sync finds), on the ``--flat-shards 4`` run its sha256 equal to the CPU
    encoder's on a host copy of the saved state, and one more period (2
    steps and a sync) from the saved and from the restored state with equal
    fingerprints and the impl's launches (``block_select``, or
    ``update_max`` and ``tail_hist``; the train CLI run's attention launches
    too); it prints the file's GB, write and read seconds and GB/s, the free
    disk (it fails when the file cannot fit) and the host's resident set
    during the write, the read and the CPU encoding."""
    dev = torch.device("cuda")
    t12 = time.perf_counter()
    cfg = olmo_config(layers=CKPT_LAYERS)
    N, counters, by_path = N_CLUSTERS, sync_kernels(), card.by_path

    # 12b first (nothing on the card): the dry-run on both production meshes
    for multi in (False, True):
        rec = D.dryrun_pair("olmo-1b", "train_4k", multi_pod=multi, verbose=False)
        if rec["status"] != "ok":
            raise AssertionError(f"dryrun: {rec}")
        emit({"phase": "dryrun", **rec})
    hfl = sharded_hfl("fused")
    with D.fake_world(1):
        mesh = M.make_host_mesh(data=1, model=1, device_type="cpu")
        state_sds = st.train_input_specs(cfg, get_shape("train_4k"), mesh, hfl)[0]
    arg_bytes, n_leaves = D.argument_bytes((state_sds,)), len(jax_leaves(state_sds))
    file_bytes = arg_bytes + sum(  # bf16 leaves are written as f32, + headers
        l.block_nbytes for l in jax_leaves(state_sds.params)) + 64 * n_leaves + 64
    free(torch)
    params = init_model(torch.Generator(device=dev).manual_seed(5), cfg, device=dev)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    state = H.hfl_init(params, SGDM(momentum=0.9, weight_decay=1e-4), hfl)
    torch.cuda.synchronize()
    growth = torch.cuda.memory_allocated() - before
    emit({"phase": "dryrun_vs_card", "arch": cfg.name, "layers": CKPT_LAYERS,
          "tiers": MAIN_ARGV[2], "argument_bytes": arg_bytes, "leaves": n_leaves,
          "hfl_init_allocated_bytes": growth, "difference": growth - arg_bytes,
          "allowed": 512 * n_leaves})
    if abs(growth - arg_bytes) > 512 * n_leaves:
        raise AssertionError(f"dryrun: argument bytes {arg_bytes} against "
                             f"{growth} allocated by hfl_init")
    del state, params
    free(torch)

    # 12a. checkpoints through the train CLI
    for impl, shards in CKPT_RUNS:
        name = impl + (f"-shards{shards}" if shards > 1 else "")
        d = CKPT_DIR / name
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
        disk_free = shutil.disk_usage(d).free
        if disk_free < 1.05 * file_bytes:
            raise AssertionError(f"checkpoint {name}: the file needs "
                                 f"{file_bytes / 1e9:.1f} GB, the disk has "
                                 f"{disk_free / 1e9:.1f} GB free")
        grab = {}
        real_save = train.save_checkpoint

        def timed_save(path, step, tree, keep=3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with HostRss() as rss:
                out = real_save(path, step, tree, keep)
            grab["write_s"] = time.perf_counter() - t0
            grab["write_rss"] = rss.report()
            grab["tree"] = tree
            return out

        free(torch)
        torch.cuda.reset_peak_memory_stats()
        since = LaunchCount({**counters, **attn_kernels()})
        second0 = fops.shard_select_candidates.second_launches
        argv = MAIN_ARGV + ["--layers", str(CKPT_LAYERS), "--omega-impl", impl,
                            "--flat-shards", str(shards), "--ckpt-dir", str(d)]
        train.save_checkpoint = timed_save
        try:
            out = train.run(train.parse_args(argv))
        finally:
            train.save_checkpoint = real_save
        torch.cuda.synchronize()
        launches = since.read()
        second = fops.shard_select_candidates.second_launches - second0
        by_path[f"ckpt olmo-1b {CKPT_LAYERS} layers {name}"] = launches
        per_sync = {k: (shards * (N + 1) if shards > 1 else N + 1)
                    for k in IMPL_KERNELS[impl]}
        for k, n in per_sync.items():
            want = n * (STEPS // PERIOD) + (second if k == "block_select" else 0)
            if launches[k] != want:
                raise AssertionError(f"checkpoint {name}: {k} launched "
                                     f"{launches[k]} times, want {want}")
        for k, n in train_attn_want(argv).items():
            if launches[k] != n:
                raise AssertionError(f"checkpoint {name}: {k} launched "
                                     f"{launches[k]} times, want {n}")
        if not (math.isfinite(out["eval_loss"]) and all(map(math.isfinite, out["hist"]))):
            raise AssertionError(f"checkpoint {name}: non-finite loss")
        path = d / f"ckpt_{STEPS:08d}.msgpack"
        size = path.stat().st_size
        saved = H.HFLState(**grab.pop("tree"))

        # restore into a fresh card state: every leaf bit for bit, in place
        fresh = H.hfl_init(init_model(torch.Generator(device=dev).manual_seed(6), cfg,
                                      device=dev),
                           SGDM(momentum=0.9, weight_decay=1e-4),
                           sharded_hfl(impl, shards=shards))
        spec = fl.spec_of(fresh.w_ref, shards=shards)
        bufs = [fl.backing(fresh.w_ref, spec), fl.backing(fresh.e, spec),
                fl.backing(fresh.eps, spec, rows=N)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with HostRss() as read_rss:
            tree, step = ck.restore_checkpoint(str(d), fresh._asdict())
            torch.cuda.synchronize()
        read_s = time.perf_counter() - t0
        restored = H.HFLState(**tree)
        leaves_equal = all(torch.equal(a, b) for a, b in zip(
            tree_leaves(tensors_of(restored)), tree_leaves(tensors_of(saved)),
            strict=True)) and restored.step == saved.step == step == STEPS
        again = [fl.backing(restored.w_ref, spec), fl.backing(restored.e, spec),
                 fl.backing(restored.eps, spec, rows=N)]
        backed = all(a is not None and b is not None and a.data_ptr() == b.data_ptr()
                     for a, b in zip(bufs, again))
        if not (leaves_equal and backed):
            raise AssertionError(f"checkpoint {name}: restored leaves equal "
                                 f"{leaves_equal}, flat buffers kept {backed}")

        sha = None
        if (impl, shards) == CKPT_SHA_RUN:
            sha = compare_file_with_cpu_encoder(path, saved)

        # one more period from the saved and from the restored state
        hcfg = sharded_hfl(impl, shards=shards)
        step_fn = H.make_cluster_train_step(
            st.make_loss_fn(cfg), SGDM(momentum=0.9, weight_decay=1e-4),
            lambda t: 0.01)
        gen = torch.Generator(device=dev).manual_seed(7)
        batches = [{"tokens": torch.randint(0, cfg.vocab_size, (N, 8, 128), generator=gen,
                                            device=dev)} for _ in range(PERIOD)]
        since = LaunchCount(counters)
        second0 = fops.shard_select_candidates.second_launches
        prints = []
        for s0 in (saved, restored):
            sync = H.make_sync(H.SyncPlan(hcfg))
            for b in batches:
                s0, _ = step_fn(s0, b)
            s0 = sync(s0)
            torch.cuda.synchronize()
            prints.append([fingerprint(torch, l) for l in tree_leaves(tensors_of(s0))])
        resume = since.read()
        resume_second = fops.shard_select_candidates.second_launches - second0
        by_path[f"ckpt olmo-1b {CKPT_LAYERS} layers {name} resume x2"] = resume
        for k, n in per_sync.items():
            want = 2 * n + (resume_second if k == "block_select" else 0)
            if resume[k] != want:
                raise AssertionError(f"checkpoint {name}: resume {k} launched "
                                     f"{resume[k]} times, want {want}")
        if prints[0] != prints[1]:
            raise AssertionError(f"checkpoint {name}: the restored state's next "
                                 "period differs from the unsaved state's")
        del restored, fresh, tree, bufs, again
        emit({"phase": "checkpoint", "run": name, "arch": cfg.name, "layers": CKPT_LAYERS,
              "tiers": MAIN_ARGV[2], "impl": impl, "flat_shards": shards,
              "file_gb": size / 1e9, "predicted_file_gb": file_bytes / 1e9,
              "write_s": grab["write_s"], "write_gb_per_s": size / 1e9 / grab["write_s"],
              "read_s": read_s, "read_gb_per_s": size / 1e9 / read_s,
              "disk_free_gb_before": disk_free / 1e9,
              "host_rss_write": grab["write_rss"], "host_rss_read": read_rss.report(),
              "sha256_vs_cpu_encoder": sha,
              "launches": launches, "resume_launches": resume,
              "second_block_select_launches": [second, resume_second],
              "restored_leaves_equal": leaves_equal, "flat_buffers_kept": backed,
              "resume_fingerprints_equal": True, "losses": out["hist"],
              "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
              "card": card.smi})
        del saved, out
        free(torch)
        shutil.rmtree(d)
    emit({"phase": "checkpoint_and_dryrun_done", "seconds": time.perf_counter() - t12})


# ---- phase 13: long context ------------------------------------------------
# 13a: the main path at train_4k's length (its batch of 256 cut to 2 MUs x 1
# a cluster); 13b: the serving twin at prefill_32k's length (its batch of 32
# cut to 2: the full batch's olmo-1b cache is 137.4 GB, its K alone 68.7 GB)
LONG_SEQ, LONG_STEPS = 4096, 4
LONG_ARGV = ["--full", "--tiers", f"{N_CLUSTERS}x2:H={PERIOD}", "--sync", "sparse",
             "--omega-impl", "fused", "--batch-per-mu", "1", "--seq", str(LONG_SEQ),
             "--steps", str(LONG_STEPS), "--log-every", "1", "--device", "cuda"]
PREFILL_LEN, PREFILL_BATCH, PREFILL_NEW = 32768, 2, 8
PREFILL_ARCHS = ("olmo-1b", "h2o-danube-3-4b")
# 13b's decode == forward in f32 at 2 layers: arch -> prompt; one decoded
# token makes the total a multiple of 512 (a length the reference takes);
# danube's 8,192 tokens wrap its 4,096-slot ring cache
LONG_CACHE_RUNS = {"olmo-1b": 1023, "h2o-danube-3-4b": 8191, "deepseek-v2-236b": 2047}
# 13c: kernel against plain version: name -> (B, T, S, H, Hkv, Dk, Dv, window,
# q_offset); the first is the headline (olmo-1b at train_4k); then 13b's
# prefills and phase 4's cluster batch (2 MUs x 4 rows of 128 tokens)
ATTN_SHAPES = {
    "olmo-1b train_4k": (2, 4096, 4096, 16, 16, 128, 128, 0, 0),
    "olmo-1b prefill_32k": (PREFILL_BATCH, PREFILL_LEN, PREFILL_LEN,
                            16, 16, 128, 128, 0, 0),
    "danube3-4b prefill_32k": (PREFILL_BATCH, PREFILL_LEN, PREFILL_LEN,
                               32, 8, 120, 120, 4096, 0),
    "olmo-1b seq 128": (8, 128, 128, 16, 16, 128, 128, 0, 0),
    "danube3-4b window": (1, 8192, 8192, 32, 8, 120, 120, 4096, 0),
    "deepseek-v2 mla": (1, 2048, 2048, 128, 128, 192, 128, 0, 0),
    "one tile": (2, 384, 384, 4, 2, 64, 64, 0, 0),
    "q_offset": (1, 100, 612, 8, 2, 128, 128, 0, 512),
    "ragged": (1, 1000, 1000, 4, 4, 112, 112, 300, 0),
    "reduced d16": (2, 96, 96, 4, 4, 16, 16, 0, 0),
    "reduced d32": (2, 160, 160, 4, 2, 32, 32, 64, 0),
}
# shapes held forward only: their path runs no backward (olmo's prefill is
# also 13c's timed backward shape, so its gradients are held too)
ATTN_FORWARD_ONLY = ("danube3-4b prefill_32k",)
ATTN_TOL = {"fwd": (1e-5, 1e-6), "grad": (1e-4, 1e-5)}  # f32 (rtol, atol)
# bf16 results: the share of entries whose bits may differ from the plain
# version's. The kernels compute the plain version's f32 function up to the
# order of f32 sums, so a rounded entry differs only where that drift
# straddles a rounding boundary; rounding P or dS once to bf16 (2^-9
# relative a term) moves far more entries (PERF.md, 13c's controls)
BF16_DIFF_SHARE = 0.02
# shapes where lower-precision controls must fail 13c's checks (T = S,
# causal, no window, as many kv heads as q heads: SDPA flash's domain)
ATTN_CONTROLS = ("olmo-1b train_4k", "olmo-1b seq 128")
BF16_TFLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate


def attn_kernels():
    """The attention kernels by name (their wrappers' ``launches``
    counters): the flash kernels of train and prefill, and the decode
    step's, the CUDA-core and the tensor-core kernel of each apart."""
    return {"flash_attn_fwd": FA.flash_attn_fwd, "flash_attn_bwd": FA.flash_attn_bwd,
            "decode_attn": DA.decode_attn, "mla_decode_attn": DA.mla_decode_attn,
            "decode_attn_tc": DA.decode_attn_tc,
            "mla_decode_attn_tc": DA.mla_decode_attn_tc}


def decode_launches_want(cfg, steps):
    """Decode kernel launches of ``steps`` decode steps of ``cfg``: one an
    attention site a step, on the kernel ``route`` picks for the model's
    dtype and widths (MLA's through ``mla_decode_attn``)."""
    import torch


    n = steps * attn_sites(cfg)
    dtype = getattr(torch, cfg.dtype)
    if cfg.use_mla:
        name = "mla_decode_attn"
        widths, group = (cfg.kv_lora_rank, cfg.qk_rope_head_dim), None
    else:
        name = "decode_attn"
        widths, group = (cfg.resolved_head_dim,), cfg.num_heads // max(1, cfg.num_kv_heads)
    if DA.route(dtype, widths, group) == DA.TENSOR_CORES:
        name += "_tc"
    want = dict.fromkeys(("decode_attn", "mla_decode_attn", "decode_attn_tc",
                          "mla_decode_attn_tc"), 0)
    want[name] = n
    return want


def attn_sites(cfg):
    """Attention calls in one forward (or prefill) of ``cfg``: one a layer,
    the hybrid's shared-block sites, none in a pure SSM."""
    if cfg.arch_type == "ssm":
        return 0
    return num_shared_attn_sites(cfg) if cfg.arch_type == "hybrid" else cfg.num_layers


def attn_launches_want(sites, steps, clusters, seq):
    """Attention kernel launches of a train CLI run with remat, for a model
    with ``sites`` attention calls a forward: each step runs every
    cluster's forward, its recompute and its backward; the eval forwards
    its 32 rows in chunks of ``EVAL_CHUNK_TOKENS``."""
    chunks = -(-32 // max(1, EVAL_CHUNK_TOKENS // seq))
    return {"flash_attn_fwd": steps * clusters * 2 * sites + chunks * sites,
            "flash_attn_bwd": steps * clusters * sites, "decode_attn": 0,
            "mla_decode_attn": 0, "decode_attn_tc": 0, "mla_decode_attn_tc": 0}


def train_attn_want(argv):
    """``attn_launches_want`` for ``train.run(train.parse_args(argv))``
    (``N_CLUSTERS`` clusters), the model resolved as the CLI does."""
    args = train.parse_args(argv)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    assert cfg.remat, "attn_launches_want counts the remat recompute"
    return attn_launches_want(attn_sites(cfg), args.steps, N_CLUSTERS, args.seq)


def kept_pairs(T, S, window, q_offset):
    """(q, k) pairs the causal / window mask keeps."""
    qpos = q_offset + np.arange(T)
    hi = np.minimum(qpos, S - 1)
    lo = np.maximum(0, qpos - window + 1) if window else np.zeros_like(qpos)
    return int(np.maximum(0, hi - lo + 1).sum())


def attn_bound(shape, elem, backward):
    """(bound ms, bound_by): each operand read once and each result written
    once over the memory rate; the products the kept pairs need, those with
    both operands of the inputs' type (S, dP) and those with an f32 operand
    (P . V; dS . K, dS^T . Q, P^T . dO). In bf16 every product runs at the
    tensor cores' bf16 rate, the ones with an f32 operand three times (its
    exact split into three bf16 parts); in f32 all at the f32 rate. The
    larger of the two times."""
    B, T, S, H, Hkv, Dk, Dv, window, q_offset = shape
    pairs = B * H * kept_pairs(T, S, window, q_offset)
    qkv = (B * T * H * Dk + B * S * Hkv * (Dk + Dv)) * elem
    o_lse = B * T * H * (Dv + 1) * 4
    if backward:  # S and dP again; dV, dQ and dK with P or dS
        low, f32 = 2 * pairs * (Dk + Dv), 2 * pairs * (2 * Dk + Dv)
        nbytes = 2 * qkv + o_lse + B * T * H * Dv * elem
    else:  # S = Q K^T; P V
        low, f32 = 2 * pairs * Dk, 2 * pairs * Dv
        nbytes = qkv + o_lse
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    if elem == 2:
        t_ops = (low + 3 * f32) / BF16_TFLOPS * 1e3
    else:
        t_ops = (low + f32) / F32_FLOPS * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def attn_compare(torch, got, want, kind, bf16):
    """(max |diff|, worst diff over its allowance, share of bf16 elements
    whose bits differ or None): f32 at ATTN_TOL; bf16 one bf16 ulp of the
    larger value (or the f32 atol where that is larger: values near 0 that
    cancellation leaves), and the share of entries that differ at all."""
    rtol, atol = ATTN_TOL[kind]
    g, w = got.float(), want.float()
    d = (g - w).abs()
    if bf16:
        big = torch.maximum(g.abs(), w.abs()).clamp_min(1e-30)
        allow = torch.exp2(torch.floor(torch.log2(big)) - 7).clamp_min(atol)
        share = float((got.view(torch.int16) != want.view(torch.int16)).float().mean())
    else:
        allow, share = atol + rtol * w.abs(), None
    return float(d.max()), float((d / allow).max()), share


def attn_failed(r):
    """Whether an ``attn_compare`` result breaks its tolerance."""
    return not r[1] <= 1.0 or (r[2] is not None and not r[2] <= BF16_DIFF_SHARE)


def rounded_p_forward(torch, q, k, v):
    """The causal forward in f32 with P rounded once to bf16 before P . V:
    the function of a kernel that kept only the split's hi part (and of
    SDPA's flash backend). A control that the f32 check of ``o32`` must
    refuse; for T = S, no window and as many kv heads as q heads."""
    qf, kf, vf = (t.float().transpose(1, 2) for t in (q, k, v))  # [B,H,T,D]
    s = (qf @ kf.transpose(-1, -2)) * (1.0 / math.sqrt(q.shape[-1]))
    T = s.shape[-1]
    s.masked_fill_(torch.ones(T, T, dtype=torch.bool, device=s.device).triu(1), -1e30)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    del s
    l = p.sum(-1, keepdim=True)
    return ((p.to(torch.bfloat16).float() @ vf) / l).transpose(1, 2)


def sdpa_flash(torch, q, k, v, do):
    """SDPA's flash backend on the bf16 inputs (causal): (out, dq, dk, dv) in
    the port's [B, T, heads, D] layout. It rounds P and dS to bf16 before
    the products that take them: not the same function, a control."""
    import torch.nn.functional as Fn
    from torch.nn.attention import SDPBackend, sdpa_kernel

    qb, kb, vb = (t.transpose(1, 2).contiguous().requires_grad_(True) for t in (q, k, v))
    with sdpa_kernel([SDPBackend.FLASH_ATTENTION]):
        out = Fn.scaled_dot_product_attention(qb, kb, vb, is_causal=True)
        grads = torch.autograd.grad(out, (qb, kb, vb), do.transpose(1, 2))
    return tuple(t.detach().transpose(1, 2) for t in (out, *grads))


def attn_kernel_checks(torch, FA, gen):
    """Phase 13c: ``flash_attn_fwd``/``_bwd`` against their plain versions
    at every ``ATTN_SHAPES`` entry in f32 and bf16, and two backward
    launches bit for bit. In bf16 the kernel's f32 ``o32`` is held at the
    f32 tolerance too, and each bf16 result may differ from the plain
    version's bits in at most ``BF16_DIFF_SHARE`` of its entries. At
    ``ATTN_CONTROLS`` two lower-precision controls go through the same
    checks and must fail them: the forward with P rounded once to bf16
    (``o32``), and SDPA's flash backend (the output and every gradient).
    Returns the checks by "<shape> <dtype>"."""
    dev = torch.device("cuda")
    checks, controls = {}, {}
    for name, shape in ATTN_SHAPES.items():
        B, T, S, H, Hkv, Dk, Dv, window, q_offset = shape
        kw = dict(q_offset=q_offset, window=window)
        for dt in (torch.float32, torch.bfloat16):
            bf16 = dt == torch.bfloat16
            q = torch.randn(B, T, H, Dk, generator=gen, device=dev).to(dt)
            k = torch.randn(B, S, Hkv, Dk, generator=gen, device=dev).to(dt)
            v = torch.randn(B, S, Hkv, Dv, generator=gen, device=dev).to(dt)
            do = torch.randn(B, T, H, Dv, generator=gen, device=dev).to(dt)
            o32, lse = FA.flash_attn_fwd(q, k, v, **kw)
            po, plse = FA.flash_attn_fwd_plain(q, k, v, **kw)
            res = {"out": attn_compare(torch, o32.to(dt), po.to(dt), "fwd", bf16),
                   "lse": attn_compare(torch, lse, plse, "fwd", False)}
            if bf16:  # the f32 output before its rounding: the same function
                res["o32"] = attn_compare(torch, o32, po, "fwd", False)
            grads = pgrads = ()
            repeat_bitwise = None
            if name not in ATTN_FORWARD_ONLY:
                grads = FA.flash_attn_bwd(q, k, v, o32, lse, do, **kw)
                again = FA.flash_attn_bwd(q, k, v, o32, lse, do, **kw)
                bits = torch.int16 if bf16 else torch.int32
                repeat_bitwise = all(torch.equal(a.view(bits), b.view(bits))
                                     for a, b in zip(grads, again))
                del again
                pgrads = FA.flash_attn_bwd_plain(q, k, v, po, plse, do, **kw)
            for gname, a, b in zip(("dq", "dk", "dv"), grads, pgrads):
                res[gname] = attn_compare(torch, a, b, "grad", bf16)
            if bf16 and name in ATTN_CONTROLS:
                ctrl = sdpa_flash(torch, q, k, v, do)
                controls[name] = {
                    "rounded P o32": attn_compare(
                        torch, rounded_p_forward(torch, q, k, v), po, "fwd", False),
                    **{f"sdpa flash {n}": attn_compare(torch, a, b, kind, True)
                       for n, a, b, kind in zip(("out", "dq", "dk", "dv"), ctrl,
                                                (po.to(dt), *pgrads),
                                                ("fwd", "grad", "grad", "grad"))}}
                del ctrl
                emit({"control": "flash_attn", "shape": name, "dims": shape,
                      "max_abs_err": {k2: r[0] for k2, r in controls[name].items()},
                      "worst_over_allowance": {k2: r[1] for k2, r in controls[name].items()},
                      "bf16_diff_share": {k2: r[2] for k2, r in controls[name].items()
                                          if r[2] is not None},
                      "fails": {k2: attn_failed(r) for k2, r in controls[name].items()}})
            torch.cuda.synchronize()
            checks[f"{name} {'bf16' if bf16 else 'f32'}"] = res
            emit({"check": "flash_attn", "shape": name, "dims": shape,
                  "dtype": str(dt).split(".")[-1],
                  "backward": name not in ATTN_FORWARD_ONLY,
                  "bwd_repeat_bitwise": repeat_bitwise,
                  "max_abs_err": {k2: r[0] for k2, r in res.items()},
                  "worst_over_allowance": {k2: r[1] for k2, r in res.items()},
                  "bf16_diff_share": {k2: r[2] for k2, r in res.items()
                                      if r[2] is not None}})
            bad = {k2: r for k2, r in res.items() if attn_failed(r)}
            if bad:
                raise AssertionError(f"flash_attn {name} {dt}: kernel and plain "
                                     f"version differ beyond the tolerance: {bad}")
            if repeat_bitwise is False:
                raise AssertionError(f"flash_attn_bwd {name} {dt}: two launches on "
                                     "the same inputs differ")
            del q, k, v, do, o32, lse, po, plse, grads, pgrads
            free(torch)
    passed = {f"{n} {k2}": r for n, c in controls.items() for k2, r in c.items()
              if not attn_failed(r)}
    if passed or set(controls) != set(ATTN_CONTROLS):
        raise AssertionError("flash_attn: lower-precision controls pass the checks, "
                             f"which then cannot tell the exact split apart: {passed}")
    return checks


def long_context(torch, card):
    """Phase 13, long context. (a) The main path at train_4k's length
    through ``train.run`` (full olmo-1b, ``LONG_ARGV``: ``--seq 4096
    --batch-per-mu 1``, fused, 4 steps): sync ms, peak, the attention
    kernels' launches against what the path implies (remat's recompute and
    the eval's 8,192-token chunks included) and ``block_select``'s as in
    phase 4; then one cluster's loss forward and backward at [2, 4096] with
    ``remat`` off and on (the same loss, the gradients held bit for bit,
    both peaks). (b) The serving twin at prefill_32k's length, batch 2, 8
    new tokens, for ``PREFILL_ARCHS`` (danube3-4b's window 4096: the ring
    cache wraps): prefill s, decode ms/step, peak, one forward launch a
    layer and one decode launch a layer a decode step; decode == forward in
    f32 at 2 layers and lengths the reference takes (``LONG_CACHE_RUNS``)
    at 2e-3. (c) ``flash_attn_fwd``/``_bwd`` against their plain versions at
    ``ATTN_SHAPES`` in f32 and bf16 with the controls that must fail
    (``attn_kernel_checks``); then both kernels timed at olmo's train_4k and
    prefill_32k shapes beside their bounds (every product at the bf16
    tensor-core rate, those with the f32 P or dS three times), SDPA
    (efficient backend) on f32 copies, and SDPA's flash backend on the bf16
    inputs (it rounds P to bf16: not the same function). Adds each run's
    launches to ``card.by_path`` and each timing to ``card.kernels``."""
    dev = torch.device("cuda")
    t13 = time.perf_counter()
    limit = PEAK_LIMIT_GB * 1e9
    counted = dict(attn_kernels(), block_select=FK.block_select)
    by_path, smi, kernels = card.by_path, card.smi, card.kernels

    # 13a. the main path at train_4k's length
    cfg = get_config("olmo-1b")
    identical = []

    def on_sync(i, state, seconds):
        identical.append(rows_identical(torch, state))

    free(torch)
    torch.cuda.reset_peak_memory_stats()
    since = LaunchCount(counted)
    out = train.run(train.parse_args(LONG_ARGV), on_sync=on_sync)
    launches = since.read()
    peak = torch.cuda.max_memory_allocated()
    syncs = LONG_STEPS // PERIOD
    want = train_attn_want(LONG_ARGV)
    want["block_select"] = (N_CLUSTERS + 1) * syncs
    emit({"phase": "long_train", "arch": cfg.name, "layers": cfg.num_layers,
          "seq": LONG_SEQ, "argv": LONG_ARGV, "losses": out["hist"],
          "eval_loss": out["eval_loss"],
          "first_step_s": out["timing"]["compile_s"],
          "sync_ms": [1e3 * s for s in out["sync_s"]],
          "max_memory_allocated_gb": peak / 1e9, "launches": launches,
          "launches_want": want, "rows_identical_after_sync": identical, "card": smi})
    by_path[f"olmo-1b seq {LONG_SEQ} fused"] = launches
    if launches != want:
        raise AssertionError(f"long train: launches {launches}, want {want}")
    if not (len(identical) == syncs and all(identical)):
        raise AssertionError("long train: cluster rows differ after a sync")
    if not (math.isfinite(out["eval_loss"]) and all(math.isfinite(l) for l in out["hist"])):
        raise AssertionError("long train: non-finite loss")
    if peak >= limit:
        raise AssertionError(f"long train: peak {peak / 1e9:.2f} GB")
    del out
    free(torch)

    # one cluster's loss forward and backward at [2, LONG_SEQ], remat off and on
    params = init_model(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
    toks = torch.randint(0, cfg.vocab_size, (2, LONG_SEQ),
                         generator=torch.Generator().manual_seed(11)).to(dev)
    leaves, treedef = tree_flatten(params)
    remat_runs = {}
    for remat in (False, True):
        c = dataclasses.replace(cfg, remat=remat)
        req = [l.detach().requires_grad_(True) for l in leaves]
        free(torch)
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        since = LaunchCount(counted)
        t0 = time.perf_counter()
        loss, _ = make_loss_fn(c)(tree_unflatten(treedef, req), {"tokens": toks})
        grads = torch.autograd.grad(loss, req, allow_unused=True)
        torch.cuda.synchronize()
        launches = since.read()
        sec = time.perf_counter() - t0
        remat_runs[remat] = dict(
            loss=float(loss.detach()), seconds=sec, launches=launches,
            peak_gb=torch.cuda.max_memory_allocated() / 1e9,
            peak_above_params_gb=(torch.cuda.max_memory_allocated() - base) / 1e9)
        if remat:
            remat_runs[True]["grads_bitwise_equal"] = all(
                (a is None and b is None) or torch.equal(a, b)
                for a, b in zip(grads_off, grads))
        else:
            grads_off = grads
        del loss, grads, req
    del grads_off
    emit({"phase": "long_remat", "arch": cfg.name, "tokens": [2, LONG_SEQ],
          "remat_off": remat_runs[False], "remat_on": remat_runs[True], "card": smi})
    L = cfg.num_layers
    if (remat_runs[False]["launches"]["flash_attn_fwd"] != L
            or remat_runs[True]["launches"]["flash_attn_fwd"] != 2 * L
            or any(r["launches"]["flash_attn_bwd"] != L for r in remat_runs.values())):
        raise AssertionError(f"long remat: launches {remat_runs}")
    if remat_runs[False]["loss"] != remat_runs[True]["loss"]:
        raise AssertionError("long remat: the loss changed with remat")
    if not remat_runs[True]["grads_bitwise_equal"]:
        raise AssertionError("long remat: the gradients changed with remat")
    if not remat_runs[True]["peak_gb"] < remat_runs[False]["peak_gb"]:
        raise AssertionError("long remat: remat did not lower the peak")
    del params, leaves
    free(torch)

    # 13b. prefill at prefill_32k's length, then decode
    for arch in PREFILL_ARCHS:
        free(torch)
        since = LaunchCount(counted)
        out = serve_batched.run(arch, batch=PREFILL_BATCH, prompt_len=PREFILL_LEN,
                                new_tokens=PREFILL_NEW, device="cuda", full=True)
        launches = since.read()
        acfg = get_config(arch)
        finite = bool(torch.isfinite(out["logits"][..., :acfg.vocab_size].float()).all())
        emit({"phase": "long_prefill", "arch": arch, "layers": out["layers"],
              "batch": PREFILL_BATCH, "prompt": PREFILL_LEN, "new_tokens": PREFILL_NEW,
              "window": acfg.sliding_window, "prefill_s": out["prefill_s"],
              "decode_ms_per_step": out["decode_ms_per_step"],
              "finite_logits": finite, "peak_gb": out["peak_gb"],
              "launches": launches, "card": smi})
        by_path[f"{arch} prefill {PREFILL_LEN}"] = launches
        want_dec = decode_launches_want(acfg, PREFILL_NEW - 1)
        if (launches["flash_attn_fwd"] != acfg.num_layers or launches["flash_attn_bwd"]
                or {k: launches[k] for k in want_dec} != want_dec):
            raise AssertionError(f"prefill {arch}: launches {launches}")
        if not finite or tuple(out["tokens"].shape) != (PREFILL_BATCH, PREFILL_NEW):
            raise AssertionError(f"prefill {arch}: non-finite logits or bad tokens")
        if out["peak_gb"] * 1e9 >= limit:
            raise AssertionError(f"prefill {arch}: peak {out['peak_gb']:.1f} GB")
        del out

    for arch, T in LONG_CACHE_RUNS.items():
        c = dataclasses.replace(get_config(arch), num_layers=2, dtype="float32")
        if c.num_experts:  # as phase 9b: no token dropped by the routing
            c = dataclasses.replace(c, capacity_factor=max(
                8.0, c.num_experts / c.experts_per_token))
        V = c.vocab_size
        free(torch)
        torch.cuda.reset_peak_memory_stats()
        params = init_model(torch.Generator(device=dev).manual_seed(0), c, device=dev)
        toks = torch.randint(0, V, (1, T + 1),
                             generator=torch.Generator().manual_seed(12)).to(dev)
        with torch.no_grad():
            full, _ = forward(params, toks, c)
            _, cache = prefill(params, toks[:, :T], c, max_len=T + 1)
            since = LaunchCount(counted)
            dl, cache = decode_step(params, cache, toks[:, T:], c)
            launches = since.read()
        got, want_l = dl[:, 0, :V], full[:, T, :V]
        err = float((got - want_l).abs().max())
        ok = bool(torch.allclose(got, want_l, rtol=CACHE_TOL, atol=CACHE_TOL))
        want_dec = decode_launches_want(c, 1)
        by_path[f"{arch} decode == forward at {T + 1}"] = launches
        if {k: launches[k] for k in want_dec} != want_dec:
            raise AssertionError(f"long cache {arch}: decode launches {launches}")
        emit({"phase": "long_cache", "arch": arch, "layers": 2, "prompt": T,
              "decoded": 1, "total": T + 1, "dtype": "float32",
              "window": c.sliding_window, "cache_slots": cache["slot_pos"].shape[1],
              "max_abs_err": err, "tol": CACHE_TOL, "decode_launches": launches,
              "peak_gb": torch.cuda.max_memory_allocated() / 1e9, "card": smi})
        if not ok:
            raise AssertionError(f"long cache {arch}: decode differs from forward by {err}")
        del params, full, cache, dl

    # 13c. the kernels against their plain versions
    gen = torch.Generator(device=dev).manual_seed(13)
    checks = attn_kernel_checks(torch, FA, gen)

    # timings at olmo's train_4k and prefill_32k shapes, bf16
    import torch.nn.functional as Fn
    from torch.nn.attention import SDPBackend, sdpa_kernel

    for tag, reps, plain in (("olmo-1b train_4k", 5, True),
                             ("olmo-1b prefill_32k", 1, False)):
        shape = ATTN_SHAPES[tag]
        B, T, S, H, Hkv, Dk, Dv, window, q_offset = shape
        q = torch.randn(B, T, H, Dk, generator=gen, device=dev).to(torch.bfloat16)
        k = torch.randn(B, S, Hkv, Dk, generator=gen, device=dev).to(torch.bfloat16)
        v = torch.randn(B, S, Hkv, Dv, generator=gen, device=dev).to(torch.bfloat16)
        do = torch.randn(B, T, H, Dv, generator=gen, device=dev).to(torch.bfloat16)
        o32, lse = FA.flash_attn_fwd(q, k, v)
        fwd_ms = cuda_ms(torch, lambda: FA.flash_attn_fwd(q, k, v), reps)
        bwd_ms = cuda_ms(torch, lambda: FA.flash_attn_bwd(q, k, v, o32, lse, do), reps)
        plain_fwd = plain_bwd = None
        if plain:
            plain_fwd = cuda_ms(torch, lambda: FA.flash_attn_fwd_plain(q, k, v), 1)
            plain_bwd = cuda_ms(torch, lambda: FA.flash_attn_bwd_plain(
                q, k, v, o32, lse, do), 1)
        # SDPA on f32 copies ([B, H, T, D]), timed and used nowhere in the port
        qf, kf, vf = (t.float().transpose(1, 2).contiguous().requires_grad_(True)
                      for t in (q, k, v))
        dof = do.float().transpose(1, 2).contiguous()
        with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
            sdpa = lambda: Fn.scaled_dot_product_attention(qf, kf, vf, is_causal=True)
            lib_fwd = cuda_ms(torch, sdpa, reps)
            so = sdpa()
            lib_bwd = cuda_ms(torch, lambda: torch.autograd.grad(
                so, (qf, kf, vf), dof, retain_graph=True), reps)
        del so, qf, kf, vf, dof
        # SDPA's flash backend on the bf16 inputs: it rounds P to bf16 before
        # P . V, so it is not the same function; timed beside, used nowhere
        qb, kb, vb = (t.transpose(1, 2).contiguous().requires_grad_(True)
                      for t in (q, k, v))
        dob = do.transpose(1, 2).contiguous()
        with sdpa_kernel([SDPBackend.FLASH_ATTENTION]):
            sdpa = lambda: Fn.scaled_dot_product_attention(qb, kb, vb, is_causal=True)
            flash_fwd = cuda_ms(torch, sdpa, reps)
            so = sdpa()
            flash_bwd = cuda_ms(torch, lambda: torch.autograd.grad(
                so, (qb, kb, vb), dob, retain_graph=True), reps)
        del so, qb, kb, vb, dob
        for name, ms, plain_ms, lib_ms, flash_ms, bwd in (
                ("flash_attn_fwd", fwd_ms, plain_fwd, lib_fwd, flash_fwd, False),
                ("flash_attn_bwd", bwd_ms, plain_bwd, lib_bwd, flash_bwd, True)):
            b_ms, by = attn_bound(shape, 2, bwd)
            kernels.setdefault(name, {})[tag] = entry = dict(
                ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=by, library_ms=lib_ms,
                max_abs_err=max(r[0] for kk, r in checks[f"{tag} bf16"].items()
                                if (kk in ("dq", "dk", "dv")) == bwd),
                dims=shape, dtype="bfloat16", library="SDPA efficient, f32 copies",
                sdpa_flash_bf16_ms=flash_ms,
                sdpa_flash_bf16="rounds P to bf16: not the same function")
            emit({"timing": name, "shape": tag, **entry})
        del q, k, v, do, o32, lse
        free(torch)
    emit({"phase": "long_context_done", "seconds": time.perf_counter() - t13})


# ---- phase 14: decode at the long shapes -----------------------------------
# decode_32k (the reference's batch 128, 32,768 slots) and long_500k (batch 1,
# 524,288 tokens, the subquadratic configs), each from the cache state that a
# context of the shape's length less DECODE_NEW tokens leaves (seeded
# entries, each slot holding its position; a sliding-window ring the last
# ``window`` positions at pos mod window), then DECODE_NEW greedy steps to the
# shape's last position. Nothing prefills: the reference's dry-run lowers
# decode_step against init_cache alone (its prefill's [B, T, V] logits
# would be 33.6 GB at 524,288 tokens)
DECODE_NEW = 8
DECODE_32K, LONG_500K = 32768, 524288
# 14a: arch -> (batch, layers; None = full depth). olmo-1b's batch is cut
# from 128 to 16: its cache is 4.295 GB a sequence (549.8 GB at 128; at 16
# 68.72 GB beside 2.36 GB of weights). danube3-4b's 4,096-slot ring is 48.32
# GB at the full 128. deepseek-v2 at 2 of 60 layers (weights, as phase 9a)
DECODE_RUNS = {"olmo-1b": (16, None), "h2o-danube-3-4b": (128, None),
               "deepseek-v2-236b": (128, 2)}
LONG_ARCHS = ("mamba2-780m", "zamba2-7b", "h2o-danube-3-4b")  # 14b, full depth
# 14b's card = CPU decode in f32 at full width: arch -> layers (zamba2's 7
# hold shared attention sites at layers 0 and 6, as phase 9b)
LONG_CPU_RUNS = {"h2o-danube-3-4b": 2, "zamba2-7b": 7}
LONG_CPU_STEPS = 4
# 14c: decode_attn against its plain version: name -> (B, S, H, Hkv, D,
# window, slots, context): "full" slots hold positions 0 .. context - 1 (the
# rest empty), "ring" the last S positions of the context at pos mod S,
# "empty" none, "one" a single slot; the query sits at position context.
# Each config's decode_32k layer at a batch that leaves room for the plain
# version's f32 copies; the first is the headline (olmo-1b, 14a's batch)
DECODE_SHAPES = {
    "olmo-1b decode_32k": (16, DECODE_32K, 16, 16, 128, 0, "full", 32760),
    "danube3-4b decode_32k ring": (128, 4096, 32, 8, 120, 4096, "ring", 32760),
    "starcoder2-3b decode_32k": (128, DECODE_32K, 24, 2, 128, 0, "full", 32760),
    "granite-34b decode_32k": (128, DECODE_32K, 48, 1, 128, 0, "full", 32760),
    "llava-next-34b decode_32k": (32, DECODE_32K, 56, 8, 128, 0, "full", 32760),
    "dbrx-132b decode_32k": (32, DECODE_32K, 48, 8, 128, 0, "full", 32760),
    "musicgen-medium decode_32k": (16, DECODE_32K, 24, 24, 64, 0, "full", 32760),
    "zamba2-7b long_500k ring": (1, 4096, 32, 32, 112, 4096, "ring", 524280),
    "empty slots": (2, 1000, 8, 2, 128, 0, "empty", 0),
    "one valid slot": (2, 777, 4, 4, 64, 0, "one", 500),
    "S = 1": (3, 1, 8, 8, 128, 0, "full", 1),
    "S no split divides": (4, 5003, 8, 4, 128, 0, "full", 5003),
    "window masks most": (2, 8192, 16, 2, 128, 64, "full", 8192),
    "reduced d16": (2, 300, 4, 4, 16, 0, "full", 250),
    "reduced d32 window": (2, 300, 4, 2, 32, 64, "full", 300),
    # the tensor-core kernel's edges: a kv head's most query heads (G = 64),
    # and splits of 244 slots that its 32-slot tiles do not divide (D = 64)
    "G = 64": (2, 3000, 128, 2, 128, 0, "full", 2900),
    "span tiles do not divide": (4, 4133, 16, 4, 64, 0, "full", 4133),
}
# mla_decode_attn: name -> (B, S, H, r, dr, slots, context); deepseek-v2's
# latent at decode_32k's full batch first
MLA_SHAPES = {
    "deepseek-v2 decode_32k": (128, DECODE_32K, 128, 512, 64, "full", 32760),
    "deepseek-v2 reduced": (2, 300, 4, 64, 16, "full", 250),
    "mla empty slots": (2, 500, 40, 512, 64, "empty", 0),
    "mla S = 1": (2, 1, 128, 512, 64, "full", 1),
    # the tensor-core kernel's edges: a head chunk of 40 of its 64 rows, and
    # one ckv block (r = 64, dr = 16) under 128 heads
    "mla H = 40": (2, 3001, 40, 512, 64, "full", 2990),
    "mla r = 64, dr = 16": (8, 4100, 128, 64, 16, "full", 4000),
}
# bf16 shapes where the plain version with the softmax weights rounded once
# to bf16 must fail 14c's bf16 check
DECODE_CONTROLS = ("granite-34b decode_32k", "deepseek-v2 decode_32k")
# 14c's timed shapes (bf16): G = 1 (the CUDA-core kernel), G = 48, 12 and 4
# (the tensor-core kernel, and the CUDA-core kernel beside it), MLA
DECODE_TIMED = (("decode_attn", "olmo-1b decode_32k", 20),
                ("decode_attn", "granite-34b decode_32k", 10),
                ("decode_attn", "starcoder2-3b decode_32k", 10),
                ("decode_attn", "danube3-4b decode_32k ring", 10),
                ("mla_decode_attn", "deepseek-v2 decode_32k", 5))
MLA_QK_DIM = 192  # deepseek-v2's dn + dr
# q_abs at the model's scale: q_nope (unit variance) times W_uk (init scale
# 1/sqrt(r)) summed over dn = 128, so 0.5 (scores of unit scale, as in 14a)
MLA_Q_SCALE = 0.5


def slot_layout(torch, kind, B, S, context, device):
    """(slot_pos [B, S], q_pos [B]) int64 of a cache state (``DECODE_SHAPES``)."""
    sp = torch.full((S,), -1, dtype=torch.long, device=device)
    if kind == "full":
        n = min(S, context)
        sp[:n] = torch.arange(n, device=device)
    elif kind == "ring":
        p = torch.arange(max(0, context - S), context, device=device)
        sp[p % S] = p
    elif kind == "one":
        sp[S // 3] = context - 1
    return (sp.expand(B, S).contiguous(),
            torch.full((B,), context, dtype=torch.long, device=device))


def seeded_cache(torch, cfg, B, seq_len, context, gen, device):
    """``init_cache(cfg, B, seq_len)`` in the state a ``context``-token prefix
    leaves: every float entry a standard normal draw from ``gen``, each slot
    holding its position (a sliding-window ring the last positions at pos
    mod S; slots past the context empty), ``pos`` = context."""
    cache = init_cache(cfg, B, seq_len, device=device)
    for t in cache.values():
        if t.is_floating_point():
            t.normal_(generator=gen)
    cache["pos"].fill_(context)
    if "slot_pos" in cache:
        S = cache["slot_pos"].shape[1]
        kind = "ring" if cfg.sliding_window else "full"
        cache["slot_pos"].copy_(slot_layout(torch, kind, B, S, context, device)[0])
    return cache


def decode_bound(nbytes, low, f32_operand, elem):
    """(bound ms, bound_by): the bytes over the memory rate, or the products:
    in bf16 at the tensor cores' rate, those with the f32 softmax weights
    three times (their exact split into three bf16 parts); in f32 all at
    the f32 rate. The larger of the two."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    if elem == 2:
        t_ops = (low + 3 * f32_operand) / BF16_TFLOPS * 1e3
    else:
        t_ops = (low + f32_operand) / F32_FLOPS * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def decode_operands(torch, shape, dt, gen, dev):
    B, S, H, Hkv, D, window, kind, context = shape
    q = torch.randn(B, 1, H, D, generator=gen, device=dev).to(dt)
    k = torch.randn(B, S, Hkv, D, generator=gen, device=dev).to(dt)
    v = torch.randn(B, S, Hkv, D, generator=gen, device=dev).to(dt)
    sp, qp = slot_layout(torch, kind, B, S, context, dev)
    return q, k, v, sp, qp


def mla_operands(torch, shape, dt, gen, dev):
    B, S, H, r, dr, kind, context = shape
    qa = (MLA_Q_SCALE * torch.randn(B, H, r, generator=gen, device=dev)).to(dt)
    qr = torch.randn(B, H, dr, generator=gen, device=dev).to(dt)
    ckv = torch.randn(B, S, r, generator=gen, device=dev).to(dt)
    kr = torch.randn(B, S, dr, generator=gen, device=dev).to(dt)
    sp, pos = slot_layout(torch, kind, B, S, context, dev)
    return qa, qr, ckv, kr, sp, pos


def decode_route(DA, kname, shape, dt):
    """The kernel ``DA.route`` picks for a ``DECODE_SHAPES`` (``decode_attn``)
    or ``MLA_SHAPES`` entry in ``dt``: its counter's name."""
    if kname == "decode_attn":
        tc = DA.route(dt, (shape[4],), shape[2] // shape[3]) == DA.TENSOR_CORES
    else:
        tc = DA.route(dt, (shape[3], shape[4])) == DA.TENSOR_CORES
    return kname + "_tc" if tc else kname


def decode_call(torch, DA, kname, shape, dt, gen, dev):
    """(operands, keywords, wrapper, plain version) of a 14c shape."""
    if kname == "decode_attn":
        return (decode_operands(torch, shape, dt, gen, dev), dict(window=shape[5]),
                DA.decode_attn, DA.decode_attn_plain)
    return (mla_operands(torch, shape, dt, gen, dev), dict(qk_head_dim=MLA_QK_DIM),
            DA.mla_decode_attn, DA.mla_decode_attn_plain)


def rounded_w_decode(torch, kname, ops, kw):
    """The plain decode with the softmax weights rounded once to bf16 before
    p . v (MLA: w . ckv), in the queries' type: the function of a kernel that
    kept only the split's hi part. A control that 14c's bf16 check must
    refuse."""
    if kname == "decode_attn":
        q, k, v, sp, qp = ops
        B, _, H, D = q.shape
        Hkv = k.shape[2]
        s = torch.einsum("bhgd,bkhd->bhgk", q.float().reshape(B, Hkv, H // Hkv, D),
                         k.float()) * (1.0 / math.sqrt(D))
        s = s.masked_fill(~valid_slots(sp, qp, kw["window"])[:, None, None], NEG_INF)
        w = torch.softmax(s, dim=-1).to(torch.bfloat16).float()
        return torch.einsum("bhgk,bkhd->bhgd", w, v.float()).reshape(q.shape).to(q.dtype)
    qa, qr, ckv, kr, sp, pos = ops
    s = (torch.einsum("bhr,bsr->bhs", qa.float(), ckv.float())
         + torch.einsum("bhd,bsd->bhs", qr.float(), kr.float())
         ) / math.sqrt(kw["qk_head_dim"])
    w = torch.softmax(s.masked_fill(~valid_slots(sp, pos)[:, None], NEG_INF), dim=-1)
    return torch.einsum("bhs,bsr->bhr", w.to(torch.bfloat16).float(),
                        ckv.float()).to(qa.dtype)


def decode_kernel_checks(torch, DA, gen):
    """Phase 14c: ``decode_attn`` at every ``DECODE_SHAPES`` entry and
    ``mla_decode_attn`` at every ``MLA_SHAPES`` entry against their plain
    versions, on the kernel ``DA.route`` picks, f32 at ``ATTN_TOL`` and bf16
    within one ulp with at most ``BF16_DIFF_SHARE`` of the entries' bits
    differing (``attn_compare``); two launches bit for bit. The bf16 entries
    the tensor-core kernels take run once more on the CUDA-core kernels
    (``cuda_cores=True``), so both stay held against the plain versions. At
    ``DECODE_CONTROLS`` the plain version with the softmax weights rounded
    once to bf16 (``rounded_w_decode``) must fail the bf16 check. Returns the
    checks by "<shape> <dtype>" (" cuda cores" for the second runs)."""
    dev = torch.device("cuda")
    checks, controls = {}, {}
    runs = [("decode_attn", n, s) for n, s in DECODE_SHAPES.items()]
    runs += [("mla_decode_attn", n, s) for n, s in MLA_SHAPES.items()]
    for kname, name, shape in runs:
        for dt in (torch.float32, torch.bfloat16):
            bf16 = dt == torch.bfloat16
            ops, kw, kernel, plain = decode_call(torch, DA, kname, shape, dt, gen, dev)
            want = plain(*ops, **kw)
            routed = decode_route(DA, kname, shape, dt)
            for cuda_cores in (False, True) if routed != kname else (False,):
                got = kernel(*ops, **kw, cuda_cores=cuda_cores)
                again = kernel(*ops, **kw, cuda_cores=cuda_cores)
                bits = torch.int16 if bf16 else torch.int32
                repeat_bitwise = torch.equal(got.view(bits), again.view(bits))
                del again
                res = attn_compare(torch, got, want, "fwd", bf16)
                torch.cuda.synchronize()
                key = f"{name} {'bf16' if bf16 else 'f32'}" + (" cuda cores" if cuda_cores
                                                              else "")
                checks[key] = res
                ran = kname if cuda_cores else routed
                emit({"check": kname, "kernel": ran, "shape": name, "dims": shape,
                      "dtype": str(dt).split(".")[-1], "max_abs_err": res[0],
                      "worst_over_allowance": res[1], "bf16_diff_share": res[2],
                      "repeat_bitwise": repeat_bitwise})
                if attn_failed(res):
                    raise AssertionError(f"{ran} {name} {dt}: kernel and plain version "
                                         f"differ beyond the tolerance: {res}")
                if not repeat_bitwise:
                    raise AssertionError(f"{ran} {name} {dt}: two launches on the same "
                                         "inputs differ")
                del got
            if bf16 and name in DECODE_CONTROLS:
                controls[name] = res = attn_compare(
                    torch, rounded_w_decode(torch, kname, ops, kw), want, "fwd", True)
                emit({"control": kname, "shape": name, "dims": shape,
                      "what": "softmax weights rounded once to bf16",
                      "max_abs_err": res[0], "worst_over_allowance": res[1],
                      "bf16_diff_share": res[2], "fails": attn_failed(res)})
            del ops, want
            free(torch)
    passed = [n for n, r in controls.items() if not attn_failed(r)]
    if passed or set(controls) != set(DECODE_CONTROLS):
        raise AssertionError("decode: the rounded-weights control passes the bf16 check, "
                             f"which then cannot tell the exact split apart: {passed}")
    return checks


def decode_timings(torch, DA, gen, checks, kernels):
    """14c's timings in bf16 at ``DECODE_TIMED``: the kernel ``DA.route``
    picks and, where that is a tensor-core kernel, the CUDA-core kernel
    beside it, each beside its bound, its plain version and one SDPA call
    on f32 copies with a boolean mask (the G query heads of a kv head, or
    MLA's H heads over its one latent row, as the query rows of one head;
    whichever backend SDPA picks), timed here and used nowhere in the
    port. Each timing lands in ``kernels`` under the kernel that ran it."""
    import torch.nn.functional as Fn


    dev = torch.device("cuda")
    for kname, name, reps in DECODE_TIMED:
        if kname == "decode_attn":
            shape = DECODE_SHAPES[name]
            B, S, H, Hkv, D, window, kind, context = shape
            q, k, v, sp, qp = ops = decode_operands(torch, shape, torch.bfloat16, gen, dev)
            kw = dict(window=window)
            kernel, plain = DA.decode_attn, DA.decode_attn_plain
            nbytes = (q.numel() * 2 + k.numel() + v.numel()) * 2 + (sp.numel() + B) * 8
            low = f32op = 2.0 * B * H * S * D
            G = H // Hkv
            lq = q.float().reshape(B, Hkv, G, D)  # [B, Hkv, G, D]: G query rows
            lk, lv = (t.float().transpose(1, 2).contiguous() for t in (k, v))
            scale = 1.0 / math.sqrt(D)
        else:
            shape = MLA_SHAPES[name]
            B, S, H, r, dr, kind, context = shape
            qa, qr, ckv, kr, sp, qp = ops = mla_operands(torch, shape, torch.bfloat16,
                                                         gen, dev)
            kw = dict(qk_head_dim=MLA_QK_DIM)
            kernel, plain = DA.mla_decode_attn, DA.mla_decode_attn_plain
            nbytes = ((qa.numel() * 2 + qr.numel() + ckv.numel() + kr.numel()) * 2
                      + (sp.numel() + B) * 8)
            low, f32op = 2.0 * B * H * S * (r + dr), 2.0 * B * H * S * r
            lq = torch.cat([qa, qr], -1).float()[:, None]  # [B, 1, H, r + dr]
            lk = torch.cat([ckv, kr], -1).float()[:, None]
            lv = ckv.float()[:, None]
            scale = 1.0 / math.sqrt(MLA_QK_DIM)
        plain_ms = cuda_ms(torch, lambda: plain(*ops, **kw), 1)
        mask = valid_slots(sp, qp, kw.get("window", 0))[:, None, None]
        lib_ms = cuda_ms(torch, lambda: Fn.scaled_dot_product_attention(
            lq, lk, lv, attn_mask=mask, scale=scale), reps)
        b_ms, by = decode_bound(nbytes, low, f32op, 2)
        routed = decode_route(DA, kname, shape, torch.bfloat16)
        for ran in dict.fromkeys((routed, kname)):  # the routed kernel first
            cc = ran == kname and routed != kname
            # the CUDA-core kernel at MLA's latent takes ~136 ms a call
            n = 2 if cc and kname == "mla_decode_attn" else reps
            ms = cuda_ms(torch, lambda: kernel(*ops, **kw, cuda_cores=cc), n)
            kernels.setdefault(ran, {})[name] = entry = dict(
                ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=by, library_ms=lib_ms,
                max_abs_err=checks[f"{name} bf16" + (" cuda cores" if cc else "")][0],
                dims=shape, dtype="bfloat16", bytes=nbytes, flops=low + f32op,
                kernel=ran, library="SDPA on f32 copies, boolean mask, default backend")
            emit({"timing": ran, "shape": name, **entry})
        del ops, lq, lk, lv, mask
        free(torch)


# ---- phase 2d: the exact top-k's radix select ----------------------------
# the olmo rows' shares of zeros: the sync's bf16 drift (under a tenth of its
# entries nonzero, so nnz <= k at phi = 0.9 and t = 0: every call of the
# fused cell falls back there), and one with nnz > k, where t falls inside a
# crowd of tied bf16 magnitudes
DRIFT_ZEROS = (0.92, 0.7)
RADIX_KERNELS = ("radix_hist_kernel", "tile_count_kernel", "tile_scan_kernel",
                 "tile_write_kernel")


def drift_row(torch, n, zeros, seed, device, offset=0):
    """A seeded f32 row of n entries shaped like a sync's drift: a share
    ``zeros`` of zeros (of either sign), the rest bf16 magnitudes
    2^e (1 + m / 128), e in [-14, -9], of either sign, so the keys crowd
    into six exponents (48 digits of the first pass). The row starts
    ``offset`` entries into its buffer, as the second row of an [R, n]
    matrix with odd n starts off a 16-B boundary."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.empty(n + offset, device=device)[offset:]
    step = 1 << 26
    for a in range(0, n, step):
        m = min(step, n - a)
        u = torch.rand(m, generator=gen, device=device)
        sign = torch.where(torch.rand(m, generator=gen, device=device) < 0.5, -1.0, 1.0)
        e = torch.randint(-14, -8, (m,), generator=gen, device=device).float()
        f = torch.randint(0, 128, (m,), generator=gen, device=device).float()
        x[a:a + m] = sign * torch.where(u < zeros, 0.0, torch.exp2(e) * (1 + f / 128))
    return x


def radix_select_checks(torch, card):
    """Phase 2d, the exact top-k's radix select (``kernels/radix_select``,
    ``csrc/radix_select.cu``): the kernels' winners and keys, and the
    ordered positions, bit for bit against the plain version
    (``radix_select_plain``, ``order_winners``) at olmo's row (Q entries made
    from a seed like a sync's bf16 drift: ``DRIFT_ZEROS`` shares of zeros,
    the rest crowded into six exponents; starting off a 16-B boundary, as
    the second row of an [R, Q] matrix with odd Q does), the faithful row
    (Q = 11,173,962) and small rows (NaN, ±inf, ±0.0, subnormals; k = 1, n;
    one entry; every offset in a 16-B chunk), all but olmo's also against
    the CPU route of ``stable_topk_positions`` on a CPU copy; each size
    timed beside its bound (five reads of the row, 8 B a winner), the plain
    version's time and the device time of each kernel and the sort; each
    size's timing goes into ``card.kernels``."""
    Q, k, Qf, kf, flush = card.Q, card.k, card.Qf, card.kf, card.flush
    dev = torch.device("cuda")

    def check(name, x, kk, cpu=True):
        pos, keys = RS.radix_select(x, kk)
        top = RS.radix_topk(x, kk)
        torch.cuda.synchronize()
        ppos, pkeys = RS.radix_select_plain(x, kk)
        same(torch, [pos, keys], [ppos, pkeys], f"radix_select[{name}]")
        same(torch, [top], [RS.order_winners(ppos, pkeys)], f"radix_topk[{name}]")
        if cpu:  # the CPU route, which the tests hold against lax.top_k
            same(torch, [top.cpu()], [sp.stable_topk_positions(x.cpu(), kk)],
                 f"radix_topk[{name}] against the CPU route")
        t = int(pkeys.min())
        emit({"check": "radix_select", "case": name, "n": x.numel(), "k": kk,
              "offset": x.data_ptr() % 16 // 4, "t": t,
              "need": kk - int((pkeys > t).sum()), "bitwise_equal": True,
              "cpu_route_equal": cpu})
        del pos, keys, top, ppos, pkeys

    def timed(shape, x, kk, cold):
        fn = lambda: RS.radix_topk(x, kk)
        if cold:
            ms = cuda_ms_cold(torch, fn, 10, flush)
        else:
            ms = cuda_ms(torch, fn, 3)
        plain_ms = cuda_ms(torch, lambda: RS.radix_topk_plain(x, kk), 1)
        split = kernel_split(torch, fn, 3, names=RADIX_KERNELS)  # warm
        n = x.numel()
        b, by = bound_ms(5 * 4 * n + 8 * kk)
        card.kernels.setdefault("radix_select", {})[shape] = entry = dict(
            ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by, library_ms=None,
            max_abs_err=0.0, elements=n, k=kk,
            cold_l2=cold, hist_passes_ms=split["radix_hist_kernel"],
            hist_bound_ms=bound_ms(3 * 4 * n)[0],
            count_ms=split["tile_count_kernel"], scan_ms=split["tile_scan_kernel"],
            write_ms=split["tile_write_kernel"],
            sort_and_rest_ms=split["all"] - sum(split[k_] for k_ in RADIX_KERNELS))
        emit({"timing": "radix_select", "shape": shape, **entry})

    # small rows: specials, the ends of k, every offset in a 16-B chunk
    gen = torch.Generator(device=dev).manual_seed(29)
    T = RS.TILE
    odd = torch.randn(3 * T + 8, generator=gen, device=dev)
    pick = torch.randperm(odd.numel(), generator=gen, device=dev)
    odd[pick[:40]] = float("nan")
    odd[pick[40:80]] = float("inf")
    odd[pick[80:120]] = -float("inf")
    odd[pick[120:3000]] = 0.0
    odd[pick[3000:6000]] = -0.0
    odd[pick[6000:9000]] = torch.tensor([1e-45, 1e-40, -3e-39], device=dev).repeat(1000)
    for off in range(4):
        x = odd[off:off + 3 * T + 3]
        for kk in (1, 90, 3 * T + 3 - 5000, 3 * T + 3 - 1000, 3 * T + 3):
            check(f"NaN, ±inf, ±0.0, subnormals, offset {off}", x, kk)
    check("one entry", odd[5:6], 1)
    check("one tile", odd[2:2 + T], T // 3)
    small = drift_row(torch, 100_000, DRIFT_ZEROS[0], 101, dev, offset=1)
    check("small drift", small, sp.keep_count(small.numel(), 0.9))
    equal = torch.full((T + 77,), -1.5, device=dev)
    check("all magnitudes equal", equal, 5000)
    del odd, pick, x, equal
    free(torch)

    # the faithful row: a drift of its own and a gaussian
    for name, x in (("faithful drift", drift_row(torch, Qf, DRIFT_ZEROS[0], 102, dev)),
                    ("faithful gaussian", torch.randn(Qf, generator=gen, device=dev))):
        check(name, x, kf)
        if name == "faithful drift":
            timed("resnet18", x, kf, cold=True)
    timed("small", small, sp.keep_count(small.numel(), 0.9), cold=True)
    del x, small
    free(torch)

    # olmo's row, off a 16-B boundary, at both shares of zeros
    for zeros in DRIFT_ZEROS:
        x = drift_row(torch, Q, zeros, 103, dev, offset=1)
        check(f"olmo-1b drift, {zeros:.0%} zeros", x, k, cpu=False)
        timed("olmo-1b" if zeros == DRIFT_ZEROS[0] else "olmo-1b nnz > k", x, k, cold=False)
        del x
        free(torch)


# ---- phase 2e: SGDM's update --------------------------------------------
SGDM_STEPS = 2  # updates of each row held bit for bit, each with fresh grads
# (weight decay, Nesterov): the train CLI's SGDM and the reference's default
SGDM_CASES = ((0.0, False), (1e-4, False), (1e-4, True))
# the train CLI at full width and these layers, on both configurations: the
# counter shows every leaf of a real train step took the kernel
SGDM_TRAIN_ARGV = ["--full", "--layers", "2", "--tiers", "2x2:H=2", "--sync", "sparse",
                   "--omega-impl", "fused", "--batch-per-mu", "1", "--seq", "128",
                   "--steps", "2", "--log-every", "1", "--device", "cuda"]


def sgdm_configs():
    """olmo-1b at full width and depth; DeepSeek-V2-Lite as its benchmark
    cell holds it (``hflbench/configs/deepseek-v2-lite.json``): 7 layers,
    16 held experts, a vocabulary of 12,800; and mamba2-780m at full width
    and depth, whose f32 leaves (A_log, D, dt_bias, the norms) take the
    kernel's f32 body at thousands of entries a leaf."""
    return (get_config("olmo-1b"),
            dataclasses.replace(get_config("deepseek-v2-lite"), num_layers=7,
                                experts_held=16, vocab_size=12800),
            get_config("mamba2-780m"))


def bits_equal(torch, a, b):
    view = torch.int16 if a.element_size() == 2 else torch.int32
    return a.dtype == b.dtype and torch.equal(a.view(view), b.view(view))


def sgdm_checks(torch, card):
    """Phase 2e, SGDM's update (``kernels/sgdm``, ``csrc/sgdm.cu``): a step
    (both clusters' rows of a [2, ...] state, every leaf of the model) on the
    kernel route against the plain route (``kernels.sgdm.sgdm_plain``, the
    torch ops) on copies of the state, bit for bit in params and moments, at
    every ``SGDM_CASES`` for each of ``sgdm_configs``; every leaf counts under
    ``route=kernel``, one launch a leaf of nonzero size. Then a step timed on
    both routes (weight decay 1e-4, the train CLI's) against its bound, 14 B
    an entry of a bf16 param and 20 of an f32 one. Last, the train CLI's
    runs of ``SGDM_TRAIN_ARGV``: every leaf on the kernel."""
    N, dev = 2, torch.device("cuda")
    tree = lambda xs: {f"l{i:03d}": x for i, x in enumerate(xs)}
    for cfg in sgdm_configs():
        shapes = [(tuple(x.shape), x.dtype)
                  for x in tree_leaves(init_model(None, cfg, device="meta"))]
        Q = sum(math.prod(s) for s, _ in shapes)
        sent = sum(1 for s, _ in shapes if math.prod(s))  # leaves launched
        gen = torch.Generator(device=dev).manual_seed(31)
        rnd = lambda shape, scale, dt: (
            scale * torch.randn(shape, generator=gen, device=dev)).to(dt)
        P = [rnd((N, *s), 0.02, dt) for s, dt in shapes]
        M = [rnd((N, *s), 1e-3, torch.float32) for s, _ in shapes]
        rows = lambda xs, n: tree([x[n] for x in xs])
        for wd, nesterov in SGDM_CASES:
            Pp, Mp = [p.clone() for p in P], [m.clone() for m in M]
            opt = SGDM(momentum=0.9, weight_decay=wd, nesterov=nesterov)
            since = LaunchCount({"sgdm": SK.sgdm_update})
            with use_registry(MetricsRegistry()) as reg:
                for step in range(SGDM_STEPS):
                    lr = float(np.float32(0.1 / (step + 1)))
                    for n in range(N):
                        G = [rnd(s, 1e-2, dt) for s, dt in shapes]
                        opt.update(tree(G), {"m": rows(M, n)}, rows(P, n), lr)
                        for g, m, p in zip(G, Mp, Pp):
                            SK.sgdm_plain(g, m[n], p[n], lr, 0.9, wd, nesterov)
                        del G
            torch.cuda.synchronize()
            for i, (a, b) in enumerate(zip([*P, *M], [*Pp, *Mp])):
                if not bits_equal(torch, a, b):
                    raise AssertionError(f"sgdm[{cfg.name}, wd {wd}, nesterov {nesterov}]: "
                                         f"leaf {i % len(P)} differs from the plain route")
            leaves = reg.counter("optim.sgdm_leaves")
            counted = (leaves.value(route="kernel"), leaves.value(route="plain"))
            launched = since.read()["sgdm"]
            if (*counted, launched) != (len(shapes) * N * SGDM_STEPS, 0,
                                        sent * N * SGDM_STEPS):
                raise AssertionError(f"sgdm[{cfg.name}]: leaves by route {leaves.series}, "
                                     f"{launched} launches")
            emit({"check": "sgdm", "arch": cfg.name, "layers": cfg.num_layers, "Q": Q,
                  "leaves": len(shapes), "rows": N, "steps": SGDM_STEPS,
                  "weight_decay": wd, "nesterov": nesterov, "bitwise_equal": True,
                  "leaves_by_route": {"kernel": counted[0], "plain": counted[1]},
                  "launches": launched})
            del Pp, Mp
            free(torch)

        # a step, both rows, at the train CLI's weight decay; fixed grads
        G = [rnd(s, 1e-2, dt) for s, dt in shapes]
        opt = SGDM(momentum=0.9, weight_decay=1e-4)
        row_trees = [(rows(M, n), rows(P, n)) for n in range(N)]

        def kernel_step():
            for m, p in row_trees:
                opt.update(tree(G), {"m": m}, p, 0.05)

        def plain_step():
            for n in range(N):
                for g, m, p in zip(G, M, P):
                    SK.sgdm_plain(g, m[n], p[n], 0.05, 0.9, 1e-4, False)

        ms = cuda_ms(torch, kernel_step, 10)
        plain_ms = cuda_ms(torch, plain_step, 2)
        nbytes = N * sum(math.prod(s) * (3 * torch.empty((), dtype=dt).element_size() + 8)
                         for s, dt in shapes)
        b, by = bound_ms(nbytes)
        card.kernels.setdefault("sgdm", {})[cfg.name] = entry = dict(
            ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by, library_ms=None,
            max_abs_err=0.0, elements=N * Q, bytes=nbytes, share_of_bound=b / ms,
            launches_a_step=N * sent)
        emit({"timing": "sgdm", "shape": cfg.name, **entry})
        del P, M, G, row_trees
        free(torch)

    # the train CLI's step at full width: every leaf's update on the kernel
    for arch in ("olmo-1b", "deepseek-v2-lite"):
        since = LaunchCount({"sgdm": SK.sgdm_update})
        with use_registry(MetricsRegistry()) as reg:
            out = train.run(train.parse_args(SGDM_TRAIN_ARGV + ["--arch", arch]))
            torch.cuda.synchronize()
        leaves = reg.counter("optim.sgdm_leaves")
        counted = (leaves.value(route="kernel"), leaves.value(route="plain"))
        if counted[1] or not counted[0] or not all(map(math.isfinite, out["hist"])):
            raise AssertionError(f"sgdm train {arch}: leaves by route {leaves.series}, "
                                 f"losses {out['hist']}")
        emit({"check": "sgdm_train", "arch": arch, "argv": SGDM_TRAIN_ARGV,
              "leaves_by_route": {"kernel": counted[0], "plain": counted[1]},
              "launches": since.read()["sgdm"], "losses": out["hist"]})
        del out
        free(torch)


def long_decode(torch, card):
    """Phase 14, decode at the long shapes, each run from a seeded cache in
    the state a context of the shape's length less 8 tokens leaves
    (``seeded_cache``: nothing prefills, as in the reference's dry-run),
    then 8 greedy steps through ``launch.steps.build_decode_step`` at full
    width. (a) decode_32k (``DECODE_RUNS``; danube3-4b's 4,096-slot ring
    wraps eight times); (b) long_500k, batch 1, full depth, for
    ``LONG_ARCHS``, then card = CPU in f32 decoding 4 tokens from one seeded
    state (``LONG_CPU_RUNS``): logits at 2e-3, pos and slot_pos equal, the
    written slots at 2e-3. Each run prints decode ms/step (first
    step excluded), the cache's GB, the peak (under ``PEAK_LIMIT_GB``) and
    the decode kernels' launches against attention sites x steps, on the
    kernel the wrappers' route picks (bf16 MLA and bf16 G >= 2: the
    tensor-core kernels, ``*_tc``). (c) The decode kernels against their
    plain versions (``decode_kernel_checks``) and timed (``decode_timings``).
    Adds each run's launches to ``card.by_path`` and each timing to
    ``card.kernels``."""
    dev = torch.device("cuda")
    t14 = time.perf_counter()
    limit = PEAK_LIMIT_GB * 1e9
    counted, by_path, smi = attn_kernels(), card.by_path, card.smi

    def run(shape, arch, B, layers, seq_len):
        cfg = get_config(arch)
        if layers:
            cfg = dataclasses.replace(cfg, num_layers=layers)
        V = cfg.vocab_size
        free(torch)
        torch.cuda.reset_peak_memory_stats()
        params = init_model(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
        gen = torch.Generator(device=dev).manual_seed(14)
        context = seq_len - DECODE_NEW
        cache = seeded_cache(torch, cfg, B, seq_len, context, gen, dev)
        cache_gb = sum(t.numel() * t.element_size() for t in cache.values()) / 1e9
        tok = torch.randint(0, V, (B, 1), generator=gen, device=dev)
        step = build_decode_step(cfg)
        times = []
        since = LaunchCount(counted)
        for _ in range(DECODE_NEW):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = step(params, cache, tok)
            tok = logits[:, -1:, :V].argmax(-1)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        launches = since.read()
        peak = torch.cuda.max_memory_allocated()
        want = decode_launches_want(cfg, DECODE_NEW)
        finite = bool(torch.isfinite(logits[..., :V].float()).all())
        written = None
        if "slot_pos" in cache:  # the new positions, each in its slot
            S = cache["slot_pos"].shape[1]
            p = torch.arange(context, seq_len, device=dev)
            slot = p % S if cfg.sliding_window else p.clamp_max(S - 1)
            written = bool((cache["slot_pos"][:, slot] == p).all())
        emit({"phase": "long_decode", "shape": shape, "arch": arch,
              "layers": cfg.num_layers, "of_layers": get_config(arch).num_layers,
              "batch": B, "context": context, "last_position": seq_len - 1,
              "new_tokens": DECODE_NEW, "cache_gb": cache_gb,
              "decode_ms_per_step": 1e3 * sum(times[1:]) / (DECODE_NEW - 1),
              "step_ms": [1e3 * t for t in times], "peak_gb": peak / 1e9,
              "finite_logits": finite, "new_slots_written": written,
              "launches": launches, "launches_want": want, "card": smi})
        by_path[f"{arch} {shape} decode"] = launches
        if {k: launches[k] for k in want} != want or launches["flash_attn_fwd"]:
            raise AssertionError(f"{shape} {arch}: launches {launches}, want {want}")
        if not finite or written is False or int(cache["pos"][0]) != seq_len:
            raise AssertionError(f"{shape} {arch}: non-finite logits or a wrong cache")
        if peak >= limit:
            raise AssertionError(f"{shape} {arch}: peak {peak / 1e9:.2f} GB")
        del params, cache, logits

    # 14a. decode_32k; 14b. long_500k at full depth
    for arch, (B, layers) in DECODE_RUNS.items():
        run("decode_32k", arch, B, layers, DECODE_32K)
    for arch in LONG_ARCHS:
        run("long_500k", arch, 1, None, LONG_500K)

    # 14b. card = CPU at long_500k's positions, f32 model math at full width
    for arch, layers in LONG_CPU_RUNS.items():
        c = dataclasses.replace(get_config(arch), num_layers=layers, dtype="float32")
        V = c.vocab_size
        free(torch)
        cpu_p = init_model(torch.Generator().manual_seed(0), c, device="cpu")
        card_p = tree_map(lambda a: a.to(dev), cpu_p)
        context = LONG_500K - DECODE_NEW
        cpu_c = seeded_cache(torch, c, 1, LONG_500K, context,
                             torch.Generator().manual_seed(14), "cpu")
        card_c = {n: t.to(dev, copy=True) for n, t in cpu_c.items()}
        toks = torch.randint(0, V, (LONG_CPU_STEPS, 1, 1),
                             generator=torch.Generator().manual_seed(15))
        errs = []
        since = LaunchCount(counted)
        with torch.no_grad():
            for t in toks:
                cl, cpu_c = decode_step(cpu_p, cpu_c, t, c)
                gl, card_c = decode_step(card_p, card_c, t.to(dev), c)
                got, want_l = gl[..., :V].cpu(), cl[..., :V]
                errs.append(float((got - want_l).abs().max()))
                if not torch.allclose(got, want_l, rtol=CACHE_TOL, atol=CACHE_TOL):
                    raise AssertionError(f"long_500k {arch}: card and CPU logits differ "
                                         f"by {errs[-1]}")
        launches = since.read()
        sp_equal = torch.equal(card_c["slot_pos"].cpu(), cpu_c["slot_pos"])
        pos_equal = torch.equal(card_c["pos"].cpu(), cpu_c["pos"])
        new = (cpu_c["slot_pos"][0] >= context).nonzero()[:, 0]  # the written slots
        slot_err = max(float((card_c[n][:, :, new].cpu() - cpu_c[n][:, :, new]).abs().max())
                       for n in ("k", "v"))
        want = decode_launches_want(c, LONG_CPU_STEPS)
        emit({"phase": "long_decode_card_equals_cpu", "arch": arch, "layers": layers,
              "dtype": "float32", "positions": [context, context + LONG_CPU_STEPS - 1],
              "max_abs_err_by_step": errs, "tol": CACHE_TOL, "pos_equal": pos_equal,
              "slot_pos_equal": sp_equal, "written_slots": new.tolist(),
              "written_slots_max_abs_err": slot_err, "launches": launches,
              "card": smi})
        by_path[f"{arch} long_500k card = CPU"] = launches
        if not (pos_equal and sp_equal and len(new) == LONG_CPU_STEPS
                and slot_err <= CACHE_TOL):
            raise AssertionError(f"long_500k {arch}: card and CPU caches differ")
        if {k: launches[k] for k in want} != want:
            raise AssertionError(f"long_500k {arch}: launches {launches}, want {want}")
        del cpu_p, card_p, cpu_c, card_c

    # 14c. the kernels against their plain versions, then timed
    gen = torch.Generator(device=dev).manual_seed(141)
    checks = decode_kernel_checks(torch, DA, gen)
    decode_timings(torch, DA, gen, checks, card.kernels)
    emit({"phase": "long_decode_done", "seconds": time.perf_counter() - t14})


# ---- phase 1: the card, the build, the paths' sizes --------------------------
@dataclasses.dataclass
class Card:
    """What ``setup`` (phase 1) makes and every phase reads: the card's
    ``nvidia-smi`` line; olmo-1b's flat Q and its uplink's k at φ = 0.9;
    full-width ResNet-18's Q and its MU uplink's k; the generator the
    phases draw their random data from, in the order they run; a 128 MB
    buffer whose rewrite evicts the 50 MB L2; and what the summary reads:
    ``kernels`` (kernel -> shape -> its check's error, times and bound) and
    ``by_path`` (path -> {kernel: launches in that path's run})."""
    smi: str
    Q: int
    k: int
    Qf: int
    kf: int
    gen: object
    flush: object
    kernels: dict = dataclasses.field(default_factory=dict)
    by_path: dict = dataclasses.field(default_factory=dict)

    def rand(self, *shape):
        import torch

        return torch.randn(shape, generator=self.gen, device=self.gen.device)


def record(card, name, shape, ms, plain_ms, nbytes, nops, err, elements, **extra):
    """A kernel's time at ``shape`` beside its bound: into ``card.kernels``
    and one JSON line."""
    b, by = bound_ms(nbytes, nops)
    card.kernels.setdefault(name, {})[shape] = entry = dict(
        ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by, library_ms=None,
        max_abs_err=err, elements=elements, **extra)
    emit({"timing": name, "shape": shape, **entry})


def setup(torch):
    """Phase 1: print the card's name and power limit; build the CUDA kernels
    from ``src/repro_torch/csrc`` and print the build seconds and each
    kernel's registers, spills and shared memory (``-Xptxas -v``), each
    attention kernel's resources (``cuobjdump -res-usage``) and the count of
    its ``HGMMA`` and ``UTMALDG`` SASS instructions (``cuobjdump -sass``);
    fail if a bf16 attention kernel keeps a stack frame (a spill) or lacks
    either instruction; the paths' sizes from the port's own models at full
    width. -> the ``Card``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"phase": "build", "seconds": _build.timed_build(),
          "library": str(_build.library_path().relative_to(ROOT))})
    if _build.log_path().exists():  # the build's own log, kept beside it
        emit({"phase": "ptxas", "kernels": ptxas_report(_build.log_path().read_text())})
    # the bf16 attention kernels keep no stack frame: nothing spills (read
    # from the library itself, however it came to be built)
    usage = res_usage(_build.library_path())
    emit({"phase": "res_usage", "kernels": usage})
    tc = {k: v for k, v in usage.items() if any(t in k for t in ATTN_TC_KERNELS)}
    if not tc or any(v.get("STACK", 1) or v.get("LOCAL", 1) for v in tc.values()):
        raise AssertionError(f"bf16 attention kernels spill (or were not found): {tc}")
    # the bf16 attention kernels run on the tensor cores (HGMMA) and load by
    # TMA (UTMALDG); the f32 ones on the CUDA cores
    sass = sass_counts(_build.library_path())
    emit({"phase": "sass", "kernels": sass})
    tc = {k: v for k, v in sass.items() if any(t in k for t in ATTN_TC_KERNELS)}
    if not tc or not all(v["HGMMA"] and v["UTMALDG"] for v in tc.values()):
        raise AssertionError(f"bf16 attention kernels without HGMMA or UTMALDG: {tc}")

    # the main path's sizes, from the port's own model at full width
    cfg = olmo_config()
    Q = fl.spec_of(init_model(None, cfg, device="meta")).total  # shapes only
    k = sp.keep_count(Q, 0.9)
    emit({"phase": "sizes", "arch": cfg.name, "Q": Q, "k": k})
    # the faithful path's sizes: full-width ResNet-18, shapes only
    Qf = fl.spec_of(init_resnet18(None, width=PAPER.width, device="meta")[0]).total
    kf = sp.keep_count(Qf, PAPER.hfl.tiers[0].phi_up)  # the MU uplink's k
    emit({"phase": "sizes", "arch": "resnet18-cifar", "width": PAPER.width,
          "Q": Qf, "k": kf})
    return Card(smi=smi, Q=Q, k=k, Qf=Qf, kf=kf,
                gen=torch.Generator(device=dev).manual_seed(0),
                flush=torch.empty(32 << 20, device=dev))


# ---- phases 2 and 3: the sync kernels against their plain versions ----------
def kernel_checks(torch, card):
    """Phase 2: hold every sync kernel against its plain PyTorch version on
    the card, bitwise, on edge cases and at the paths' shapes (one JSON line
    per check), and time kernel and plain version there.

    ``block_select`` on the boundaries of its design (``cap_blk`` at, one
    before and one after a warp's and a CTA's span, 1 and ``BLOCK_ELEMS``; a
    length ending inside a span of the last tile; a tile of candidates only;
    NaN and ±inf entries). ``tail_hist`` on elements equal to edges,
    NaN/±inf/±0, collapsed edges, 1, 64 and 256 bins, 3 and 5 tiles and the
    real ResNet-18 gradient, which is timed beside the gaussian with the
    device time of its two passes (slice counts, ordered sum) from a short
    ``torch.profiler`` capture. ``apply_mask`` is compared as bit patterns
    (signs of zeros included), and ``omega_pallas``/``dgc_step_pallas`` on
    the card against the same functions on CPU copies at one row of the
    faithful path's Q; so is the fused Ω there (``sparsify.omega(
    impl="fused")``), with ``block_select`` against its plain version at
    that row's own tile capacity and threshold, on a real full-width
    ResNet-18 gradient (more candidates than the buffer holds), randn**3
    (heavy-tailed, the candidates answer) and a gaussian scaled up along the
    row (the total fits, the last tiles overflow); the branch the kernel's
    tile counts decide must be the one the card's selection took.
    ``bitpack`` against its plain version (bytes and popcounts) on edge
    cases (n = 5, a ragged two-block n, NaN/±0/±inf/subnormal entries,
    all-zero and all-one masks), on its design's boundaries (one tile, 43
    tiles, bits on both sides of every chunk and CTA span of three tiles)
    and at the comm path's and olmo-1b's shapes, with the occupancy
    calculator's clusters at once and the waves they make.
    ``block_select``, ``update_max``, ``tail_hist`` and ``bitpack`` are
    timed at one row of the faithful path's Q with the L2 cache flushed
    before every launch (the row fits in the 50 MB L2), each after a flush
    that writes and after one that reads (``bitpack`` also beside the
    events' own floor)."""
    dev = torch.device("cuda")
    rand, gen, flush = card.rand, card.gen, card.flush
    Q, Qf, kf = card.Q, card.Qf, card.kf
    BE = FK.BLOCK_ELEMS
    BE_BP = BK.BLOCK_ROWS * BK.BLOCK_COLS
    tiny = float(torch.finfo(torch.float32).tiny)
    ones = torch.ones(2 * BE, device=dev)  # every entry a candidate: slot = position
    odd = rand(2 * BE + 777)
    odd[::1001] = float("nan")  # |NaN| >= th is false
    odd[5::997] = float("inf")
    odd[7::991] = -float("inf")
    cases = [("gaussian", rand(1 << 24), 1.5, 12000),
             ("ragged", rand(3 * BE - 777), 1.0, 24000),
             ("overflow", torch.ones(2 * BE, device=dev), 0.5, 128),
             ("all-zero", torch.zeros(BE + 5, device=dev), tiny, 64),
             ("len inside a span of the last tile",
              rand(2 * BE + 3 * SELECT_CTA_SPAN + 500), 1.0, 9000),
             ("every entry a candidate", rand(2 * BE + 5), 0.0, BE),
             ("NaN and ±inf", odd, 1.5, 12000),
             ("no candidate (th = +inf)", rand(2 * BE + 5), float("inf"), 100),
             ("cap_blk = 1", rand(3 * BE), 0.5, 1),
             ("cap_blk = BLOCK_ELEMS", rand(3 * BE), 0.5, BE)]
    cases += [(f"cap_blk at {span} {d:+d}", ones, 0.5, n0 + d)
              for span, n0 in (("warp span", SELECT_WARP_SPAN),
                               ("CTA span", SELECT_CTA_SPAN))
              for d in (-1, 0, 1)]
    for name, x, th, cap in cases:
        n = x.numel()
        tht = torch.tensor([th], device=dev)
        got = FK.block_select(x, tht, cap, n)
        torch.cuda.synchronize()
        err = same_bits(torch, got, FK.block_select_plain(x, tht, cap, n),
                        f"block_select[{name}]")
        emit({"check": "block_select", "case": name, "n": n, "cap_blk": cap,
              "candidates": int(got[2].sum()), "bit_patterns_equal": True,
              "max_abs_err": err})
    del cases, x, got, ones, odd
    free(torch)

    def check_update_max(n, shape):
        rows = -(-n // (256 * 1024)) * 256
        v = rand(rows, 1024)
        if shape:  # both paths call it with u = g = 0, sigma = 0
            u = g = torch.zeros_like(v)
            sigma = 0.0
        else:
            u, g, sigma = rand(rows, 1024), rand(rows, 1024), 0.7
        got = DK.update_max(u, v, g, sigma)
        torch.cuda.synchronize()
        err = same(torch, got, DK.update_max_plain(u, v, g, sigma),
                   f"update_max[{n}]")
        emit({"check": "update_max", "n": n, "rows": rows, "sigma": sigma,
              "bitwise_equal": True, "max_abs_err": err})
        if not shape:
            return
        del got
        fn = lambda: DK.update_max(u, v, g, sigma)
        extra = {}
        if shape == "olmo-1b":
            ms = cuda_ms(torch, fn, 5)
        else:  # after the writing flush, and after a reading one
            ms = cuda_ms_cold(torch, fn, 20, flush)
            extra["ms_clean_l2"] = cuda_ms_cold(torch, fn, 20, flush, dirty=False)
        plain_ms = cuda_ms(torch, lambda: DK.update_max_plain(u, v, g, sigma), 1)
        P = rows * 1024
        # each distinct input read once (the paths pass u and g as ONE zero
        # buffer), u' and v' written once, 3 flops per element
        n_in = len({t.data_ptr() for t in (u, v, g)})
        record(card, "update_max", shape, ms, plain_ms,
               4 * P * n_in + 8 * P + 4 * (rows // 256), 3 * P, err, P, **extra)

    def check_tail_hist(v, edges, case, shape=None):
        got = DK.tail_hist(v, edges)
        torch.cuda.synchronize()
        err = same(torch, [got], [DK.tail_hist_plain(v, edges)],
                   f"tail_hist[{case}]")
        emit({"check": "tail_hist", "case": case, "rows": v.shape[0],
              "bins": edges.numel(), "bitwise_equal": True, "max_abs_err": err,
              "count_at_edge0": float(got[0])})
        if not shape:
            return
        fn = lambda: DK.tail_hist(v, edges)
        cold = shape != "olmo-1b"  # one faithful row fits in the L2
        ms = cuda_ms_cold(torch, fn, 20, flush) if cold else cuda_ms(torch, fn, 5)
        extra = ({"ms_clean_l2": cuda_ms_cold(torch, fn, 20, flush, dirty=False)}
                 if cold else {})
        split = kernel_split(torch, fn, 10 if cold else 3, flush if cold else None)
        plain_ms = cuda_ms(torch, lambda: DK.tail_hist_plain(v, edges), 1)
        P = v.numel()
        record(card, "tail_hist", shape, ms, plain_ms, 4 * P + 8 * edges.numel(),
               7 * P, err, P, data=case, slice_pass_ms=split["slice_hist_kernel"],
               ordered_sum_ms=split["tile_order_sum_kernel"], **extra)

    def lin_edges(v, bins):
        return sp.linear_edges(v.abs().max(), bins).clamp_min(tiny)

    # tail_hist edge cases: elements equal to edges, NaN/±inf/±0, the
    # collapsed edges of an all-zero row, 1 and 256 bins, and 3 and 5 tiles
    # (not a whole number of the kernel's 8 slices)
    TILE = 256 * 1024
    v = rand(3 * TILE // 1024, 1024)
    e64 = lin_edges(v, 64)
    eq = v.clone().reshape(-1)
    pick = torch.randint(0, eq.numel(), (1 << 16,), generator=gen, device=dev)
    eq[pick] = e64[torch.randint(0, 64, (1 << 16,), generator=gen, device=dev)]
    eq[pick[::2]] *= -1.0
    special = eq.clone()
    special[pick[:4096]] = torch.tensor(
        [float("nan"), float("inf"), -float("inf"), 0.0, -0.0, -float("nan"),
         3.0, -1.5], device=dev).repeat(512)
    for case, vv, ee in (
            ("elements equal to edges", eq.reshape(v.shape), e64),
            ("NaN, ±inf, ±0.0", special.reshape(v.shape), e64),
            ("all edges tiny (an all-zero row)", torch.zeros_like(v),
             lin_edges(torch.zeros_like(v), 64)),
            ("bins = 1", v, lin_edges(v, 1)), ("bins = 64", v, e64),
            ("bins = 256", v, lin_edges(v, 256)),
            ("5 tiles", rand(5 * TILE // 1024, 1024), None)):
        check_tail_hist(vv, lin_edges(vv, 64) if ee is None else ee, case)
    del v, e64, eq, special, pick, vv, ee
    for n, shape in (((1 << 24) + 12345, None), (Q, "olmo-1b"), (Qf, "resnet18")):
        check_update_max(n, shape)
        free(torch)
        rows = -(-n // TILE) * 256
        v = rand(rows, 1024)
        check_tail_hist(v, lin_edges(v, 64), f"gaussian, n = {n}", shape)
        del v
        free(torch)

    # apply_mask at the faithful path's shape (Qf padded to whole tiles),
    # with a threshold from the real update_max -> tail_hist passes
    rows_f = -(-Qf // (256 * 1024)) * 256
    v = rand(rows_f, 1024)
    u = rand(rows_f, 1024)
    th = dops.threshold_pallas(v, 0.99)
    v_odd = v.clone()  # signs of zeros and NaNs
    v_odd[0, :6] = torch.tensor([float("nan"), -0.0, 0.0, -3.0, -1e-3,
                                 float("nan")], device=dev)
    edge = [("tail_hist threshold", u, v, th),
            ("th = 0", u, v_odd, torch.zeros((), device=dev)),
            ("above every |v|", u, v, v.abs().max() * 2),
            ("negatives", u, -v.abs(), th),
            ("zero u, as on the path", torch.zeros_like(v), v, th)]
    for name, uu, vv, tt in edge:
        got = DK.apply_mask(uu, vv, tt)
        torch.cuda.synchronize()
        err = same_bits(torch, got, DK.apply_mask_plain(uu, vv, tt),
                        f"apply_mask[{name}]")
        emit({"check": "apply_mask", "case": name, "rows": rows_f,
              "bit_patterns_equal": True, "max_abs_err": err,
              "kept": int((vv.abs() >= tt).sum())})
    del got, v_odd, edge
    zero = torch.zeros_like(v)
    ms = cuda_ms(torch, lambda: DK.apply_mask(zero, v, th), 20)
    plain_ms = cuda_ms(torch, lambda: DK.apply_mask_plain(zero, v, th), 3)
    P = rows_f * 1024
    # read u (the zero buffer, a distinct operand) and v, write three outputs
    record(card, "apply_mask", "resnet18", ms, plain_ms, 20 * P + 4, 3 * P, err, P)
    del u, v, zero, th
    free(torch)

    # the whole DGC glue on the card against the same functions on CPU copies
    x = rand(Qf)
    got = dops.omega_pallas(x, 0.99)
    torch.cuda.synchronize()
    want = dops.omega_pallas(x.cpu(), 0.99)
    same_bits(torch, [got[0].cpu()], [want[0]], "omega_pallas")
    same(torch, [got[1].cpu()], [want[1]], "omega_pallas mask")
    emit({"check": "omega_pallas", "n": Qf, "phi": 0.99, "bit_patterns_equal": True,
          "kept": int(want[1].sum()), "k": kf})
    ug, vg, gg = x, rand(Qf), rand(Qf)
    got = dops.dgc_step_pallas(ug, vg, gg, 0.9, 0.99)
    torch.cuda.synchronize()
    want = dops.dgc_step_pallas(ug.cpu(), vg.cpu(), gg.cpu(), 0.9, 0.99)
    same_bits(torch, [t.cpu() for t in got], want, "dgc_step_pallas")
    emit({"check": "dgc_step_pallas", "n": Qf, "sigma": 0.9, "phi": 0.99,
          "bit_patterns_equal": True, "zeros_in_v": int((want[2] == 0).sum())})
    del x, ug, vg, gg, got, want
    free(torch)

    # the fused Ω at one row of the faithful path: block_select with that
    # row's own tile capacity and threshold estimate against its plain
    # version, and the whole selection on the card against a CPU copy
    # (which takes the exact stable sort); the branch the kernel's tile
    # counts decide must be the one the card's selection took
    w0, loss_fn, _ = pa.build(width=PAPER.width, seed=0, device=dev)
    xb, yb = SyntheticImages(seed=3).sample(PAPER.batch_per_mu)
    leaf = w0.detach().requires_grad_(True)
    batch = (torch.from_numpy(xb).to(dev), torch.from_numpy(yb).to(dev))
    (grad,) = torch.autograd.grad(loss_fn(leaf, batch), leaf)  # the MU row at step 1
    del w0, leaf, loss_fn, batch
    # tail_hist on that gradient, padded to tiles as the pallas Ω pads it
    # (its values crowd into the lowest bins, unlike the gaussian's)
    gt = dops._to_tiles(grad)[0]
    check_tail_hist(gt, lin_edges(gt, 64), "resnet18 gradient", "resnet18 gradient")
    del gt
    phi_f = PAPER.hfl.tiers[0].phi_up
    cap_f = fops.candidate_capacity(Qf, kf)
    cap_blk_f = fops.tile_capacity(Qf, cap_f)
    ramp = torch.arange(Qf, device=dev, dtype=torch.float32) / Qf
    no_th = torch.tensor([float("inf")], device=dev)  # no finite entry clears it
    for name, x in (("resnet gradient", grad), ("randn**3", rand(Qf) ** 3),
                    ("skewed tiles", rand(Qf) * torch.exp(4 * ramp))):
        th = fops._row_threshold(x[None], kf, bins=fops._BINS,
                                 sample=fops._SAMPLE, margin=fops._MARGIN)
        got = FK.block_select(x, th, cap_blk_f, Qf)
        torch.cuda.synchronize()
        same_bits(torch, got, FK.block_select_plain(x, th, cap_blk_f, Qf),
                  f"block_select[faithful {name}]")
        m = int(got[2].sum())
        overflowed = int((got[2][:, 0] > cap_blk_f).sum())
        answers = kf <= m <= cap_f and not overflowed
        with use_registry(MetricsRegistry()) as reg:
            sent, mask = sp.omega(x, phi_f, impl="fused")
            torch.cuda.synchronize()
        took = fused_outcomes(reg)
        if took != ((1, 0) if answers else (0, 1)):
            raise AssertionError(f"omega fused[{name}]: took (candidates, fallback) "
                                 f"{took}, the tile counts decide {answers}")
        want_sent, want_mask = sp.omega(x.cpu(), phi_f, impl="fused")
        same_bits(torch, [sent.cpu()], [want_sent], f"omega fused[{name}]")
        same(torch, [mask.cpu()], [want_mask], f"omega fused[{name}] mask")
        emit({"check": "omega_fused", "case": name, "n": Qf, "phi": phi_f,
              "k": kf, "capacity": cap_f, "cap_blk": cap_blk_f, "th": float(th),
              "candidates": m, "tiles_overflowed": overflowed,
              "tiles": got[2].shape[0], "answered_by": (
                  "candidates" if answers else "exact fallback"),
              "block_select_bit_patterns_equal": True,
              "card_equals_cpu_bit_patterns": True})
        if name == "resnet gradient":  # the faithful path's row and data
            ms = cuda_ms_cold(torch, lambda: FK.block_select(x, th, cap_blk_f, Qf),
                              20, flush)
            ms_clean = cuda_ms_cold(torch, lambda: FK.block_select(x, th, cap_blk_f, Qf),
                                    20, flush, dirty=False)
            # the same bytes with no candidate: every slot a pad, the walk's
            # stores predicated off
            ms_none = cuda_ms_cold(torch, lambda: FK.block_select(x, no_th, cap_blk_f,
                                                                  Qf), 20, flush)
            plain_ms = cuda_ms(torch, lambda: FK.block_select_plain(
                x, th, cap_blk_f, Qf), 3)
            nb_f = got[2].shape[0]
            record(card, "block_select", "resnet18", ms, plain_ms,
                   4 * Qf + 8 * nb_f * cap_blk_f + 4 * nb_f + 4, 2 * Qf, 0.0, Qf,
                   cap_blk=cap_blk_f, no_candidates_ms=ms_none, ms_clean_l2=ms_clean)
    del grad, ramp, x, th, got, sent, mask, want_sent, want_mask
    free(torch)

    # bitpack against its plain version: edge cases, then the comm path's
    # shape (ResNet-18's Q, 0/1 masks as the bitmap encode builds them) and
    # olmo-1b's, where launch overhead does not hide the bound
    def check_bitpack(name, flat):
        tiles, n = bops._to_tiles(flat)
        got = BK.bitpack(tiles)
        torch.cuda.synchronize()
        same(torch, got, BK.bitpack_plain(tiles), f"bitpack[{name}]")
        line = {"check": "bitpack", "case": name, "n": n, "rows": tiles.shape[0],
                "bitwise_equal": True, "set": int(got[1].sum())}
        if n <= 1 << 20:  # the stream against numpy on the host
            want = np.packbits(flat.cpu().numpy() != 0, bitorder="little").tobytes()
            if bops.bitpack_bytes(flat) != want:
                raise AssertionError(f"bitpack[{name}]: bytes differ from np.packbits")
            line["equals_np_packbits"] = True
        emit(line)
        return tiles

    odd = torch.tensor([float("nan"), -0.0, 0.0, float("inf"), -float("inf"),
                        1e-45, -1e-40, -float("nan")], device=dev)
    ragged = rand(BE_BP + 3) * (rand(BE_BP + 3) > 1.0)  # two blocks, ragged
    ragged[torch.randperm(ragged.numel(), generator=gen, device=dev)[:4096]] = (
        odd.repeat(512))
    # the design's own boundaries: a tile is a cluster of BP_CTAS CTAs, each
    # walking its span in chunks of BP_CHUNK elements; bits set on either
    # side of every chunk and span boundary of three tiles, and one tile
    edges = torch.zeros(3 * BE_BP, device=dev)
    for step in (BP_CHUNK, BE_BP // BP_CTAS, BE_BP):
        at = torch.arange(step, 3 * BE_BP, step, device=dev)
        for d in (-1, 0, 1):
            edges[(at + d).clamp(0, 3 * BE_BP - 1)] = 1.0
    for name, flat in (("n = 5", odd[:5]), ("ragged two-block", ragged),
                       ("all-zero", torch.zeros(262147, device=dev)),
                       ("all-one", torch.ones(262147, device=dev)),
                       ("one tile", (rand(BE_BP) > 1.2816).float()),
                       ("chunk and CTA-span boundaries, three tiles", edges),
                       ("43 tiles", (rand(43 * BE_BP) > 0.0).float())):
        check_bitpack(name, flat)
    del odd, ragged, edges
    bp_clusters = BK.active_clusters()
    for shape, n, reps in (("resnet18", Qf, 20), ("olmo-1b", Q, 5)):
        tiles = check_bitpack(shape, (rand(n) > 1.2816).float())  # ≈ 10 % set
        if shape == "olmo-1b":
            ms = cuda_ms(torch, lambda: BK.bitpack(tiles), reps)
            extra = {}
        else:
            ms = cuda_ms_cold(torch, lambda: BK.bitpack(tiles), reps, flush)
            # the same launch after a clean (read) flush, and the floor of
            # the method: the events around a one-element fill
            one = torch.empty(1, device=dev)
            extra = {"ms_clean_l2": cuda_ms_cold(torch, lambda: BK.bitpack(tiles),
                                                 reps, flush, dirty=False),
                     "event_floor_ms": cuda_ms_cold(torch, lambda: one.fill_(1.0),
                                                    reps, flush, dirty=False)}
        plain_ms = cuda_ms(torch, lambda: BK.bitpack_plain(tiles), 1)
        P = tiles.numel()
        # read the f32 mask once, write one bit per element and the counts
        record(card, "bitpack", shape, ms, plain_ms, 4 * P + P // 8 + 4 * (P // BE_BP),
               P, 0.0, P, tiles=P // BE_BP, active_clusters=bp_clusters,
               waves=-(-(P // BE_BP) // bp_clusters), **extra)
        del tiles
        free(torch)


def fused_selection(torch, card):
    """Phase 3: fused selection on a gaussian [2, Q] matrix:
    ``select_topk_rows`` (the ``block_select`` pipeline, which must answer
    it without the exact fallback) against the exact stable sort, timed
    beside ``torch.topk`` as the library yardstick; then ``block_select``
    alone at the main path's per-row shape and threshold, timed."""
    Q, k_ul = card.Q, card.k
    S = card.rand(N_CLUSTERS, Q)
    with use_registry(MetricsRegistry()) as reg:
        vals, idx = fops.select_topk_rows(S, k_ul)
        torch.cuda.synchronize()
    took_kernel_path = fused_outcomes(reg) == (1, 0)
    if not took_kernel_path:
        raise AssertionError("select_topk_rows: the gaussian matrix took the "
                             "exact fallback, not the block_select candidates")
    ev, ei = fops._exact_sort_rows(S, k_ul)
    same(torch, [idx, vals], [ei, ev], "select_topk_rows vs exact stable sort")
    del vals, idx, ev, ei
    free(torch)
    sel_ms = cuda_ms(torch, lambda: fops.select_topk_rows(S, k_ul), 2)
    exact_ms = cuda_ms(torch, lambda: fops._exact_sort_rows(S, k_ul), 1)
    try:  # the yardstick only; the port never calls torch.topk
        topk_ms = cuda_ms(torch, lambda: torch.topk(S.abs(), k_ul, dim=1), 1)
    except RuntimeError as exc:
        topk_ms = None
        print(f"torch.topk yardstick unavailable: {exc}", flush=True)
    emit({"check": "select_topk_rows", "shape": [N_CLUSTERS, Q], "k": k_ul,
          "identical_to_exact_sort": True, "kernel_path_exact": took_kernel_path,
          "ms": sel_ms, "exact_sort_ms": exact_ms, "library_ms": topk_ms,
          "library": "torch.topk(|S|, k, dim=1)"})
    # block_select alone at the main path's per-row shape and threshold
    cap_blk = fops.tile_capacity(Q, fops.candidate_capacity(Q, k_ul))
    th = fops._row_threshold(S, k_ul, bins=fops._BINS, sample=fops._SAMPLE,
                             margin=fops._MARGIN)
    no_th = torch.tensor([float("inf")], device=S.device)  # no finite entry clears it
    nb = -(-Q // FK.BLOCK_ELEMS)
    row = S[0]
    got = FK.block_select(row, th[0:1], cap_blk, Q)
    torch.cuda.synchronize()
    err = same(torch, got, FK.block_select_plain(row, th[0:1], cap_blk, Q),
               "block_select[main-path row]")
    emit({"check": "block_select", "case": "main-path row", "n": Q,
          "cap_blk": cap_blk, "candidates": int(got[2].sum()),
          "bitwise_equal": True, "max_abs_err": err})
    del got
    ms = cuda_ms(torch, lambda: FK.block_select(row, th[0:1], cap_blk, Q), 5)
    ms_none = cuda_ms(torch, lambda: FK.block_select(row, no_th, cap_blk, Q), 5)
    plain_ms = cuda_ms(torch, lambda: FK.block_select_plain(row, th[0:1], cap_blk, Q), 1)
    record(card, "block_select", "olmo-1b", ms, plain_ms,
           4 * Q + 8 * nb * cap_blk + 4 * nb + 4, 2 * Q, err, Q, cap_blk=cap_blk,
           no_candidates_ms=ms_none)


# ---- phase 4: the main path ---------------------------------------------------
def main_path(torch, card):
    """Phase 4: full-width olmo-1b through ``repro_torch.launch.train`` at
    ``MAIN_ARGV`` (``--full --tiers 2x2:H=2 --sync sparse --batch-per-mu 4
    --seq 128``, 4 steps, 2 syncs), once with ``--omega-impl fused`` and
    once with ``--omega-impl pallas``; each run's launch counts: the Ω
    route's kernels once a row a sync, the attention kernels' (with remat,
    two forwards and one backward a layer a cluster a step, plus the eval's
    forward), SGDM's (one a leaf a cluster a step, every leaf counted on the
    kernel route), and every exact row on the radix select's kernels; the
    rows identical after each sync; the fused run says how many of its
    selections the ``block_select`` candidates answered and how many the
    exact fallback answered."""
    cfg = olmo_config()
    leaves = tree_leaves(init_model(None, cfg, device="meta"))
    n_leaves, n_sent = len(leaves), sum(1 for x in leaves if x.numel())
    counted = {**sync_kernels(), **attn_kernels(), "radix_select": RS.radix_select,
               "sgdm": SK.sgdm_update}
    syncs = STEPS // PERIOD
    for impl in ("fused", "pallas"):
        identical = []

        def on_sync(i, state, seconds):
            identical.append(rows_identical(torch, state))

        free(torch)
        torch.cuda.reset_peak_memory_stats()
        since = LaunchCount(counted)
        args = train.parse_args(MAIN_ARGV + ["--omega-impl", impl])
        with use_registry(MetricsRegistry()) as reg:
            out = train.run(args, on_sync=on_sync)
            torch.cuda.synchronize()
        launches = since.read()
        # every exact row on the card takes the radix select's kernels
        exact = reg.counter("sparsify.exact_topk_rows")
        if (exact.value(route="plain"), exact.value(route="kernel")) != (
                0, launches["radix_select"]):
            raise AssertionError(f"{impl}: exact rows {exact.series}, radix_select "
                                 f"launched {launches['radix_select']} times")
        # every leaf's update takes SGDM's kernel: one launch a leaf a cluster a step
        sgdm = reg.counter("optim.sgdm_leaves")
        if ((sgdm.value(route="kernel"), sgdm.value(route="plain"), launches["sgdm"])
                != (n_leaves * N_CLUSTERS * STEPS, 0, n_sent * N_CLUSTERS * STEPS)):
            raise AssertionError(f"{impl}: SGDM's leaves by route {sgdm.series}, "
                                 f"launched {launches['sgdm']} times")
        peak = torch.cuda.max_memory_allocated()
        # which selections the block_select candidates answered, and which
        # the exact fallback answered after the kernel ran
        finished, fallbacks = fused_outcomes(reg)
        emit({"phase": "main_path", "impl": impl, "arch": cfg.name,
              "layers": cfg.num_layers, "d_model": cfg.d_model,
              "tiers": MAIN_ARGV[2], "steps": STEPS, "syncs": syncs,
              "losses": out["hist"], "eval_loss": out["eval_loss"],
              "first_step_s": out["timing"]["compile_s"],
              "sync_ms": [1e3 * s for s in out["sync_s"]],
              "max_memory_allocated_gb": peak / 1e9, "launches": launches,
              "fused_selections": {"kernel_pipeline": finished,
                                   "exact_fallback": fallbacks},
              "rows_identical_after_sync": identical})
        want = (N_CLUSTERS + 1) * syncs
        for name in IMPL_KERNELS[impl]:
            if launches[name] != want:
                raise AssertionError(f"{impl}: {name} launched {launches[name]} "
                                     f"times, want {want}")
        want_attn = train_attn_want(MAIN_ARGV + ["--omega-impl", impl])
        if {k: launches[k] for k in want_attn} != want_attn:
            raise AssertionError(f"{impl}: attention launches {launches}, "
                                 f"want {want_attn}")
        card.by_path[f"olmo-1b {impl}"] = launches
        if not (len(identical) == syncs and all(identical)):
            raise AssertionError(f"{impl}: cluster rows differ after a sync")
        if not (math.isfinite(out["eval_loss"])
                and all(math.isfinite(l) for l in out["hist"])):
            raise AssertionError(f"{impl}: non-finite loss")
        if impl == "fused":
            calls = finished + fallbacks
            if calls != 2 * syncs:
                raise AssertionError(f"fused: {calls} selections, "
                                     f"want {2 * syncs}")
            print(f"fused: block_select launched {launches['block_select']} "
                  f"times; {finished} of {calls} selections were answered "
                  f"from its candidates, {fallbacks} by the exact fallback "
                  f"(share {fallbacks / calls:.2f})", flush=True)
        del out


# ---- phase 5: the paper-exact path --------------------------------------------
def faithful_run(torch, card, impl):
    """One of phase 5's runs of full-width ResNet-18 under ``FaithfulHFL``
    with ``impl`` Ω, and its checks. -> the pallas run's SBS/MBS buffers
    after step 7, the state before its second sync (phase 6 reads them);
    the fused run keeps none."""
    hfl_f = PAPER.hfl  # 7 clusters x 4 MUs, H = 4, the paper's φ, β and σ
    K_f, N_f, period = hfl_f.total_mus, hfl_f.num_clusters, hfl_f.tiers[1].period
    f_syncs = F_STEPS // period
    want_f = (K_f + N_f) * F_STEPS + (2 * N_f + 1) * f_syncs
    f_kernels = {"pallas": ("update_max", "tail_hist", "apply_mask"),
                 "fused": ("block_select",)}
    sync_state, min_zeros = {}, []

    def on_step(t, sim, metrics):
        min_zeros.append(min(int((sim.state[b] == 0).sum(dim=1).min())
                             for b in ("u", "v")))
        if impl == "pallas" and t == F_STEPS - 2:
            sync_state.update({b: sim.state[b].clone() for b in
                               ("w_tilde_n", "eps_n", "w_ref", "e")})

    free(torch)
    torch.cuda.reset_peak_memory_stats()
    since = LaunchCount(sync_kernels())
    # the selections' outcomes in call order: the fused.select.* spans
    with use_tracer(SpanTracer()) as tracer:
        out = pa.run(f"faithful {impl}", hfl_f, F_STEPS,
                     batch_per_mu=PAPER.batch_per_mu, lr=F_LR, seed=0,
                     width=PAPER.width, device="cuda", omega_impl=impl,
                     on_step=on_step)
        torch.cuda.synchronize()
    launches = since.read()
    card.by_path[f"faithful {impl}"] = launches
    outcomes = [e["name"] == "fused.select.candidates"
                for e in sorted(tracer.events, key=lambda e: e["ts"])
                if e["name"].startswith("fused.select.")]
    if len(outcomes) != (want_f if impl == "fused" else 0):
        raise AssertionError(f"faithful {impl}: {len(outcomes)} fused "
                             f"selections, want {want_f} with fused only")
    hops = split_by_hop(outcomes, F_STEPS, K_f, N_f, period)
    emit({"phase": "faithful_path", "impl": impl, "arch": "resnet18-cifar",
          "width": PAPER.width, "Q": card.Qf, "clusters": N_f,
          "mus_per_cluster": hfl_f.mus_per_cluster, "period": period,
          "batch_per_mu": PAPER.batch_per_mu, "lr": F_LR,
          "steps": F_STEPS, "syncs": f_syncs, "losses": out["losses"],
          "top1": out["acc"], "first_step_s": out["first_step_s"],
          "step_s": out["step_s"],
          "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
          "launches": launches, "min_zeros_per_row": min_zeros, "k": card.kf,
          "fused_selections_by_hop": hops if impl == "fused" else None})
    for name in f_kernels[impl]:
        if launches[name] != want_f:
            raise AssertionError(f"faithful {impl}: {name} launched "
                                 f"{launches[name]} times, want {want_f}")
    if len(min_zeros) != F_STEPS or min(min_zeros) < card.kf:
        raise AssertionError(f"faithful {impl}: a u/v row holds fewer than "
                             f"k = {card.kf} zeros after a step: {min_zeros}")
    if not (math.isfinite(out["acc"]) and all(math.isfinite(l) for l in out["losses"])):
        raise AssertionError(f"faithful {impl}: non-finite loss or accuracy")
    if impl == "fused":
        print("faithful fused: selections answered from the block_select "
              "candidates / by the exact fallback, by hop: " + ", ".join(
                  f"{h} {c['kernel_pipeline']}/{c['exact_fallback']}"
                  for h, c in hops.items()), flush=True)
    return sync_state


def faithful_path(torch, card):
    """Phase 5: the paper-exact path, full-width ResNet-18 under
    ``FaithfulHFL`` through ``repro_torch.launch.paper_accuracy.run`` at the
    paper's geometry (7 clusters x 4 MUs, H = 4, φ = (0.99, 0.9, 0.9, 0.9),
    β_s = 0.5, β_m = 0.2, σ = 0.9), batch 64 per MU, lr 0.05, 8 steps (2
    syncs), once with ``--omega-impl pallas`` and once with ``fused``
    (``faithful_run``): every Ω row is one launch, (K + N)·S + (2N +
    1)·⌊S/H⌋ = 310 of each kernel of the impl; after every step every row
    of u and v must hold >= k zeros; the fused run says which selections
    the ``block_select`` candidates answered, by hop. Then the non-IID twin
    (``launch.noniid_hfl.run``: the iid, label-sorted and dirichlet(0.3)
    splits of the example at full width, batch 16 per MU, H = 4,
    ``pallas``) for ``NONIID_STEPS`` = 4 steps each, one sync each,
    3·((K + N)·4 + 2N + 1) = 465 launches of each DGC kernel, the same u/v
    zeros check. -> the pallas run's state before its second sync."""
    sync_state = faithful_run(torch, card, "pallas")
    faithful_run(torch, card, "fused")
    hfl_f, kf = PAPER.hfl, card.kf
    K_f, N_f, period = hfl_f.total_mus, hfl_f.num_clusters, hfl_f.tiers[1].period
    min_zeros = {}

    def on_split_step(split, t, sim, metrics):
        min_zeros.setdefault(split, []).append(min(
            int((sim.state[b] == 0).sum(dim=1).min()) for b in ("u", "v")))

    free(torch)
    torch.cuda.reset_peak_memory_stats()
    since = LaunchCount(sync_kernels())
    nout = noniid_hfl.run(NONIID_STEPS, period=period, width=PAPER.width,
                          device="cuda", omega_impl="pallas", on_step=on_split_step)
    torch.cuda.synchronize()
    launches = since.read()
    card.by_path["faithful non-IID pallas"] = launches
    want_n = len(nout) * ((K_f + N_f) * NONIID_STEPS
                          + (2 * N_f + 1) * (NONIID_STEPS // period))
    emit({"phase": "faithful_noniid", "impl": "pallas", "arch": "resnet18-cifar",
          "width": PAPER.width, "Q": card.Qf, "clusters": N_f, "period": period,
          "steps": NONIID_STEPS, "splits": {
              name: {"losses": r["losses"], "top1": r["acc"], "step_s": r["step_s"],
                     "min_zeros_per_row": min_zeros[name]}
              for name, r in nout.items()},
          "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
          "launches": launches, "launches_want": want_n, "k": kf})
    for name in ("update_max", "tail_hist", "apply_mask"):
        if launches[name] != want_n:
            raise AssertionError(f"non-IID: {name} launched {launches[name]} "
                                 f"times, want {want_n}")
    for name, r in nout.items():
        if not all(math.isfinite(l) for l in r["losses"] + [r["acc"]]):
            raise AssertionError(f"non-IID {name}: non-finite loss or accuracy")
        if len(min_zeros[name]) != NONIID_STEPS or min(min_zeros[name]) < kf:
            raise AssertionError(f"non-IID {name}: a u/v row holds fewer than "
                                 f"k = {kf} zeros after a step")
    return sync_state


# ---- phase 6: the comm path on the paper path's sync state ---------------------
def comm_path(torch, card, sync_state=None):
    """Phase 6: the comm path on ``sync_state``, phase 5's pallas run's
    state before its second sync (called alone, it runs that run itself),
    as an ``HFLState`` over the ResNet-18 tree at 7 clusters (φ = 0.9 up and
    down, β_s = 0.5, β_m = 0.2): ``comm.make_sync_probe`` for every
    registered codec with ``pallas`` and ``fused`` Ω; the pallas probe's 7
    uplink and 1 downlink payloads bit-equal to the same probe on a CPU
    copy, the state unchanged, ``make_sync`` on a copy of the state sending
    each impl's probed payloads (w_ref and eps bit for bit), device bit
    counts equal to the host ``measure_bits``, the bitmap streams through
    ``bitpack`` equal to numpy's and decoding back, ``bitmap_payload`` of
    the downlink card = CPU, a ``PayloadLedger`` per codec beside the
    analytic 32·(1 - φ), ``bitpack`` launched once per kernel-path encode
    and ``bitmap_payload`` call, the ``launch.comm_bits`` entry point on the
    card, and the async per-cluster sync (``sim.engine.
    make_async_sync_step``, sparse downlink, cluster 3) with ``pallas`` and
    ``fused`` Ω on the card against a CPU copy: w_ref, eps[n], e_dl[n], row
    n and the device bit counts equal, two launches of each kernel of the
    impl; and the tiered cascade (``core.hfl.HierSyncStep``) on a random
    depth-3 state of that Q, 2 edges x 3 clusters, with ``pallas`` and
    ``hist``: the hier probe's bits of a top-2 boundary, that cascade, a
    unit sync and a root push, every row card = CPU bit for bit, 27
    launches each."""
    if sync_state is None:
        sync_state = faithful_run(torch, card, "pallas")
    hfl_f, Qf, counters = PAPER.hfl, card.Qf, sync_kernels()
    K_f, N_f = hfl_f.total_mus, hfl_f.num_clusters
    t6 = time.perf_counter()
    free(torch)
    spec_f = fl.spec_of(init_resnet18(None, width=PAPER.width, device="meta")[0])
    if spec_f.total != Qf or set(sync_state) != {"w_tilde_n", "eps_n", "w_ref", "e"}:
        raise AssertionError("comm: the faithful run left no sync state of Q")

    def hfl_state(rows):  # SBS models / uplink errors, MBS model / error
        return HFLState(params=fl.unpack_stacked(rows["w_tilde_n"], spec_f), opt={},
                        w_ref=fl.unpack(rows["w_ref"], spec_f),
                        eps=fl.unpack_stacked(rows["eps_n"], spec_f),
                        e=fl.unpack(rows["e"], spec_f), step=F_STEPS - 1)

    rows_d = {b: t.clone() for b, t in sync_state.items()}
    state_d = hfl_state(rows_d)
    comm_cfg = {impl: dataclasses.replace(hfl_f, omega_impl=impl)
                for impl in ("pallas", "fused")}
    names = list(cod.CODECS)
    cheap = [n for n in names if n.startswith(("dense", "bitmap"))]
    since = LaunchCount(counters)
    probe_bits, payloads = {}, {}
    for impl, cfg_i in comm_cfg.items():
        probe_bits[impl] = {}
        for name in names:
            ul, dl = acc.make_sync_probe(cfg_i, name)(state_d)
            probe_bits[impl][name] = [int(b) for b in ul] + [int(dl)]
        ups, down = acc.make_sync_probe(cfg_i, "bitmap").payloads(state_d)
        payloads[impl] = ups + [down]
    torch.cuda.synchronize()
    probe_launches = since.read()
    for b, t in rows_d.items():  # the probes left the state as it was
        if not torch.equal(t.view(torch.int32), sync_state[b].view(torch.int32)):
            raise AssertionError(f"comm: the sync probe changed {b}")
    # the pallas probe's payloads on the card against a CPU copy of the state
    state_c = hfl_state({b: t.cpu() for b, t in sync_state.items()})
    ups_c, down_c = acc.make_sync_probe(comm_cfg["pallas"], "bitmap").payloads(state_c)
    for j, ((v, i), (vc, ic)) in enumerate(zip(payloads["pallas"], ups_c + [down_c])):
        same_bits(torch, [v.cpu()], [vc], f"comm payload {j} values")
        same(torch, [i.cpu()], [ic], f"comm payload {j} indices")
    del state_c, ups_c, down_c
    # device counts against the host measure_bits: every codec on uplink 0
    # and the downlink, the cheap codecs on all 8 payloads
    host_checked = 0
    for impl, pl in payloads.items():
        for name in names:
            codec = cod.get_codec(name)
            for j, (v, i) in enumerate(pl):
                dev_bits = int(codec.measure_bits_torch(v, i, Qf))
                if dev_bits != probe_bits[impl][name][j]:
                    raise AssertionError(f"comm {impl} {name}: probe and payload "
                                         f"counts differ on payload {j}")
                if name in cheap or j in (0, N_f):
                    if codec.measure_bits(v, i, Qf) != dev_bits:
                        raise AssertionError(f"comm {impl} {name}: device and host "
                                             f"counts differ on payload {j}")
                    host_checked += 1
    # the bitmap streams through the bitpack kernel, on the pallas payloads
    kernel_encodes = 0
    for j, (v, i) in enumerate(payloads["pallas"]):
        for name in ("bitmap", "bitmap-q8"):
            codec = cod.get_codec(name)
            got = codec.encode(v, i, Qf, impl="pallas")
            kernel_encodes += 1
            if not np.array_equal(got, codec.encode(v, i, Qf)):
                raise AssertionError(f"comm {name}: kernel and numpy streams "
                                     f"differ on payload {j}")
            if 8 * got.size != probe_bits["pallas"][name][j]:
                raise AssertionError(f"comm {name}: stream length != measured bits")
            cv, ci = codec._coalesce(v, i)
            dv, di = codec.decode(got, Qf)
            # by value: q8 codes carry no sign of zero, its wire values may
            if not (np.array_equal(di, ci)
                    and np.array_equal(dv, codec.wire_values(cv))):
                raise AssertionError(f"comm {name}: decode(encode) is not the "
                                     f"payload on payload {j}")
    # bitmap_payload of the dense downlink payload, card against CPU
    dvals, didx = payloads["pallas"][N_f]
    d = sp.unpack_topk(dvals, didx, Qf)
    packed, vals = bops.bitmap_payload(d)
    packed_c, vals_c = bops.bitmap_payload(d.cpu())
    if packed != packed_c or not np.array_equal(vals.view(np.int32),
                                                vals_c.view(np.int32)):
        raise AssertionError("comm: bitmap_payload differs between card and CPU")
    del d
    torch.cuda.synchronize()
    comm_launches = since.read()
    if comm_launches["bitpack"] != kernel_encodes + 1:
        raise AssertionError(f"comm: bitpack launched {comm_launches['bitpack']} "
                             f"times, want {kernel_encodes + 1}")
    want_probe = (len(names) + 1) * (N_f + 1)  # one Ω per payload per probe run
    for impl, kern in (("pallas", ("update_max", "tail_hist")),
                       ("fused", ("block_select",))):
        for name in kern:
            if probe_launches[name] != want_probe:
                raise AssertionError(f"comm {impl}: {name} launched "
                                     f"{probe_launches[name]} times, want {want_probe}")
    card.by_path["comm (ResNet-18 sync state)"] = comm_launches
    # what make_sync then sends on a copy of the state is what each probe
    # measured: w_ref' = w_ref + d, eps'_n = drift_n - sent_n, bit for bit
    for impl, cfg_i in comm_cfg.items():
        rows_s = {b: t.clone() for b, t in sync_state.items()}
        drift = rows_s["eps_n"].clone()
        H._pack_drift(drift, state_d.params, rows_s["w_ref"],
                      cfg_i.tiers[1].beta_up, spec_f)
        new = H.make_sync(H.SyncPlan(cfg_i))(hfl_state(rows_s))
        dvals, didx = payloads[impl][N_f]
        want = sync_state["w_ref"].clone().index_add_(0, didx.long(), dvals)
        same_bits(torch, [fl.pack(new.w_ref)[0]], [want],
                  f"comm {impl}: sync w_ref vs probe")
        eps1 = fl.pack_stacked(new.eps)[0]
        for n, (v, i) in enumerate(payloads[impl][:N_f]):
            want = drift[n].index_add_(0, i.long(), -v)
            same_bits(torch, [eps1[n]], [want], f"comm {impl}: sync eps {n} vs probe")
        del rows_s, drift, want, new, eps1
    torch.cuda.synchronize()
    # the ledger of one sync round per codec: measured fronthaul payloads,
    # synthetic access payloads, beside the analytic 32·(1 - φ) bits/param
    t0, t1 = hfl_f.tiers
    phis = {"mu_ul": t0.phi_up, "sbs_dl": t0.phi_down, "sbs_ul": t1.phi_up,
            "mbs_dl": t1.phi_down}
    ledgers = {}
    for impl in payloads:
        ledgers[impl] = {}
        for name in names:
            led = acc.PayloadLedger(codec=name, size=Qf)
            led.record("mu_ul", acc.access_bits(name, Qf, phis["mu_ul"]) * K_f,
                       events=K_f)
            led.record("sbs_dl", acc.access_bits(name, Qf, phis["sbs_dl"]) * N_f,
                       events=N_f)
            led.record("sbs_ul", sum(probe_bits[impl][name][:N_f]), events=N_f)
            led.record("mbs_dl", probe_bits[impl][name][N_f])
            summ = led.summary()
            ledgers[impl][name] = {
                "bits_per_param": {l: led.bits[l] / (led.events[l] * Qf)
                                   for l in acc.LINKS},
                "bits_per_param_mean": summ["bits_per_param_mean"]}
    emit({"phase": "comm_ledger", "Q": Qf, "clusters": N_f, "mus": K_f,
          "analytic_bits_per_param": {l: 32.0 * (1.0 - p) for l, p in phis.items()},
          "k": {l: sp.keep_count(Qf, p) for l, p in phis.items()},
          "ledgers": ledgers})
    # the entry point, on the card at its default size
    t_cb = time.perf_counter()
    cb_rows, cb = comm_bits.run(device="cuda")
    torch.cuda.synchronize()
    for tag, metrics in cb_rows:
        print(f"{tag},{metrics}", flush=True)
    if not (cb["dense_f32_matches_analytic_phi0"]
            and cb["sparse_codecs_beating_analytic_at_0.99"]):
        raise AssertionError("comm_bits: an invariant failed")
    # the async per-cluster sync (sparse downlink) on that state: the card
    # against a CPU copy, bit for bit, for both kernel routes
    n_a, w_a = 3, E.async_weight(2, N_f)
    edl0 = 0.01 * card.rand(N_f, Qf)  # a downlink error with every entry set
    since = LaunchCount(counters)
    async_check = {}
    for impl, cfg_i in comm_cfg.items():
        got = {}
        for where in ("cuda", "cpu"):
            rows = {b: t.clone() if where == "cuda" else t.cpu()
                    for b, t in sync_state.items()}
            step = E.make_async_sync_step(cfg_i, dl_sparse=True, codec="delta-varint")
            st, e_dl, bits = step(hfl_state(rows), edl0.clone() if where == "cuda"
                                  else edl0.cpu(), n_a, w_a)
            got[where] = ([fl.pack(st.w_ref)[0], rows["eps_n"][n_a], e_dl[n_a],
                           rows["w_tilde_n"][n_a]],
                          [int(bits[k]) for k in ("sbs_ul", "mbs_dl")])
            del rows, st, e_dl
        for what, a, b in zip(("w_ref", "eps[n]", "e_dl[n]", "row n"),
                              got["cuda"][0], got["cpu"][0]):
            same_bits(torch, [a.cpu()], [b], f"async sync {impl}: {what}")
        if got["cuda"][1] != got["cpu"][1]:
            raise AssertionError(f"async sync {impl}: bits {got['cuda'][1]} on "
                                 f"the card, {got['cpu'][1]} on the CPU")
        async_check[impl] = {"bits_sbs_ul_mbs_dl": got["cuda"][1]}
        del got
    torch.cuda.synchronize()
    async_launches = since.read()
    want_a = {k: 0 for k in counters}
    for impl in comm_cfg:  # one uplink and one downlink Ω per sync
        for k in IMPL_KERNELS[impl]:
            want_a[k] = 2
    if async_launches != want_a:
        raise AssertionError(f"async sync: launches {async_launches}, want {want_a}")
    card.by_path["comm async sync (ResNet-18 sync state)"] = async_launches
    del edl0
    emit({"check": "async_sync", "Q": Qf, "clusters": N_f, "cluster": n_a,
          "weight": w_a, "dl_sparse": True, "card_equals_cpu_bit_patterns": True,
          "launches": async_launches, **async_check})
    # the tiered cascade (core.hfl.HierSyncStep) on a random depth-3 state of
    # the faithful path's Q, 2 edges x 3 clusters (tier 1's group mean is a
    # multiply by f32(1/3), its δ an fma): a top-2 cascade, a unit sync and a
    # root push, and the hier probe's bits before them, on the card against a
    # CPU copy, bit for bit, with the pallas and hist routes
    gh = torch.Generator().manual_seed(5)
    noise = lambda rows, sc: sc * torch.randn((rows, Qf), generator=gh)
    w0 = noise(1, 1.0)
    hier_rows = {"params": w0 + noise(6, 0.1), "w_ref": w0[0].clone(),
                 "eps": noise(6, 0.01), "e": noise(1, 0.01)[0],
                 "refs": w0 + noise(2, 0.05), "eps2": noise(2, 0.01),
                 "errs": noise(2, 0.01)}
    hier_launches, hier_check = {k: 0 for k in counters}, {}
    for impl in ("pallas", "hist"):
        cfg_h = HFLConfig(tiers=parse_tiers_spec("2x3x2:H=2,2"), omega_impl=impl)
        got = {}
        for where in ("cuda", "cpu"):
            since = LaunchCount(counters)
            r = {k: v.clone().to(where) for k, v in hier_rows.items()}
            st = HFLState(params=fl.unpack_stacked(r["params"], spec_f), opt={},
                          w_ref=fl.unpack(r["w_ref"], spec_f),
                          eps=fl.unpack_stacked(r["eps"], spec_f),
                          e=fl.unpack(r["e"], spec_f), step=0)
            bufs = H.HierBufs(refs=(r["refs"],), eps=(r["eps2"],), errs=(r["errs"],))
            uls, dls = acc.make_hier_sync_probe(cfg_h, "delta-varint")(st, bufs, 2)
            bits = [int(b) for b in torch.cat([*uls, *dls])]
            step = H.HierSyncStep(cfg_h)
            unit_sync, push = step.unit_ops(2)
            snaps = []
            for call in (lambda st, b: step(st, b, 2),
                         lambda st, b: unit_sync(st, b, 1, 1),
                         lambda st, b: push(st, b, 2, 1, E.async_weight(1, 2))):
                st, bufs = call(st, bufs)
                snaps.append([v.to("cpu", copy=True) for v in r.values()])
            if where == "cuda":
                torch.cuda.synchronize()
                for k, n in since.read().items():
                    hier_launches[k] += n
            got[where] = (bits, snaps)
            del r, st, bufs
        if got["cuda"][0] != got["cpu"][0]:
            raise AssertionError(f"hier probe {impl}: bits {got['cuda'][0]} on the "
                                 f"card, {got['cpu'][0]} on the CPU")
        for call, a_, b_ in zip(("cascade top 2", "unit sync", "root push"),
                                got["cuda"][1], got["cpu"][1]):
            for name, x, y in zip(hier_rows, a_, b_):
                same_bits(torch, [x], [y], f"hier {impl} {call}: {name}")
        hier_check[impl] = {"probe_bits_ul_dl": got["cuda"][0]}
        del got
    want_h = {k: 0 for k in counters}
    for k in IMPL_KERNELS["pallas"]:  # probe 11 + cascade 11 + unit 4 + push 1
        want_h[k] = 27
    if hier_launches != want_h:
        raise AssertionError(f"hier check: launches {hier_launches}, want {want_h}")
    card.by_path["hier sync check (ResNet-18 Q, 2x3x2)"] = hier_launches
    emit({"check": "hier_sync", "Q": Qf, "tiers": "2x3x2:H=2,2",
          "calls": ["probe top 2", "cascade top 2", "unit_sync u=1", "push t=2 a=1"],
          "card_equals_cpu_bit_patterns": True, "launches": hier_launches,
          **hier_check})
    del hier_rows, w0
    emit({"phase": "comm_path", "Q": Qf, "impls": list(payloads),
          "codecs": names, "payloads_per_probe": N_f + 1,
          "payload_k": [int(v.numel()) for v, _ in payloads["pallas"]],
          "pallas_payloads_card_equal_cpu": True, "state_unchanged": True,
          "sync_sends_probe_payloads": list(comm_cfg),
          "host_count_checks": host_checked, "kernel_encodes": kernel_encodes,
          "bitmap_payload_card_equal_cpu": True, "launches": comm_launches,
          "comm_bits": {"size": cb["size"], "crossover": cb["bitmap_to_delta_crossover_phi"],
                        "winner_0.99": cb["best_winner_by_phi"]["0.99"]["codec"],
                        "seconds": time.perf_counter() - t_cb},
          "seconds": time.perf_counter() - t6})


# ---- phase 7: the simulator's path --------------------------------------------
# (scenario or, for the async root, tiers; Ω impl; extra train CLI flags), at
# full olmo-1b width; paper-fig3 first (phase 8a reruns it)
SIM_RUNS = (("paper-fig3", "pallas", ["--layers", str(FIG3_LAYERS),
                                      "--payload-accounting", "measured",
                                      "--codec", "delta-varint"]),
            # the seeds make the checks bite (the fleet is numpy, the same on
            # every machine): seed 3 drops a straggler in both rounds, seed 8
            # has a cluster sit out each round, seed 25 re-associates an MU
            # (and moves its shard) within the run
            ("stragglers", "fused", MAIN_ARGV[1:3] + ["--sim-seed", "3"]),
            ("dropout", "pallas", MAIN_ARGV[1:3] + ["--sim-seed", "8"]),
            ("async", "pallas", MAIN_ARGV[1:3] + ["--payload-accounting", "measured",
                                                  "--codec", "delta-varint"]),
            ("trace-replay", "fused", MAIN_ARGV[1:3] + ["--sim-seed", str(TRACE_SEED)]),
            ("scale-1m", "pallas", ["--layers", str(SCALE_LAYERS)]),
            # the depth-3 trees (2 edges x 2 SBSs x 4 MUs) at their depth cut:
            # 4 clusters' state and the tier buffers
            ("hier-3tier", "pallas", ["--layers", str(HIER_LAYERS),
                                      "--payload-accounting", "measured",
                                      "--codec", "delta-varint", "--trace-viz",
                                      str(OBS_DIR / "hier-3tier.json"),
                                      "--metrics-out", str(OBS_DIR / "hier-3tier.jsonl")]),
            ("hier-deadline", "pallas", ["--layers", str(HIER_LAYERS),
                                         "--sim-seed", str(HIER_DEADLINE_SEED)]),
            (ASYNC_ROOT, "pallas", ["--layers", str(HIER_LAYERS)]))


def alloc_retries():
    """The caching allocator's retries so far: each freed the cached blocks
    and allocated again (a stall near the card's capacity)."""
    return torchprof.device_memory_stats().get("num_alloc_retries", 0)


def check_async_root(card, name, args, hfl_s, out, launches, peak, sat_out, events):
    """The async-root tree through run_hfl (the unit scheduler without a
    radio): every unit round a within-unit tier-1 sync (G uplinks and
    one downlink Ω), every tiers[2].period rounds a root push (one Ω)."""
    n_s, H_s = hfl_s.num_clusters, hfl_s.tiers[1].period
    U = hfl_s.agg_count(1)
    G, rounds = n_s // U, STEPS // H_s
    cfg = olmo_config()
    syncs = [e for e in events if e["kind"] == "unit_sync"]
    pushes = [e for e in events if e["kind"] == "push"]
    want = dict.fromkeys(launches, 0)
    for k in IMPL_KERNELS[args.omega_impl]:
        want[k] = len(syncs) * (G + 1) + len(pushes)
    emit({"phase": "sim_path", "scenario": None, "tiers": name,
          "impl": args.omega_impl, "discipline": "async root (unit scheduler)",
          "arch": cfg.name, "layers": args.layers, "d_model": cfg.d_model,
          "clusters": n_s, "units": U, "mus_per_cluster": hfl_s.mus_per_cluster,
          "steps": STEPS, "losses": out["hist"], "eval_loss": out["eval_loss"],
          "first_unit_round_s": out["timing"]["compile_s"],
          "sync_ms": [1e3 * x for x in out["sync_s"]],
          "max_memory_allocated_gb": peak / 1e9, "events": events,
          "sat_out_by_step": sat_out, "launches": launches,
          "launches_want": want, "card": card.smi})
    if launches != want or want["update_max"] + want["block_select"] != 14:
        raise AssertionError(f"sim {name}: launches {launches}, want {want}")
    if not (len(syncs) == U * rounds and len(pushes) == U * rounds
            // hfl_s.tiers[2].period and all(e["rows_ok"] for e in events)):
        raise AssertionError(f"sim {name}: unit events {events}")
    if not all(0 < e["weight"] <= 1 / hfl_s.tiers[2].fanout for e in pushes):
        raise AssertionError(f"sim {name}: push weights {pushes}")
    # every train call trains one unit; the other unit's rows sit out
    if not (len(sat_out) == U * rounds * H_s
            and all(len(o) == n_s - G for o in sat_out)):
        raise AssertionError(f"sim {name}: sat-out {sat_out}")
    if not (math.isfinite(out["eval_loss"])
            and all(math.isfinite(l) for l in out["hist"])):
        raise AssertionError(f"sim {name}: non-finite loss")
    if peak / 1e9 >= PEAK_LIMIT_GB:
        raise AssertionError(f"sim {name}: peak {peak / 1e9:.2f} GB")


def sim_run(torch, card, name, impl, extra):
    """One of phase 7's runs (a ``SIM_RUNS`` entry) through the train CLI,
    with its checks. -> a scenario run's argv, losses, virtual clock,
    launches, peak and allocator retries (None for the async root)."""
    OBS_DIR.mkdir(parents=True, exist_ok=True)
    cfg, counters = olmo_config(), sync_kernels()
    as_int = lambda x: x.view(torch.int16 if x.element_size() == 2 else torch.int32)
    scenario = name != ASYNC_ROOT  # the async root runs without a scenario
    argv = ((["--full", "--scenario", name] if scenario
             else ["--full", "--tiers", name])
            + ["--omega-impl", impl, "--batch-per-mu", "4", "--seq", "128",
               "--steps", str(STEPS), "--log-every", "1", "--device", "cuda"]
            + extra)
    args = train.parse_args(argv)
    hfl_s = HFLConfig(tiers=parse_tiers_spec(args.tiers or "4x2:H=4"))
    if scenario:
        scn = get_scenario(name)
        hfl_s = apply_hfl_overrides(scn, hfl_s)
    n_s, H_s = hfl_s.num_clusters, hfl_s.tiers[1].period
    hier = hfl_s.depth > 2
    asyn = not hier and scn.sim.discipline == "async"
    measured = args.payload_accounting == "measured"
    identical, sat_out, events, masked, last = [], [], [], [], {}
    tops, unit_events = [], []

    def on_sync(i, state, seconds, event=None):
        if event is None:  # lockstep/deadline: every row is the consensus
            identical.append(rows_identical(torch, state))
            return
        if event.get("kind") == "cascade":
            # rows identical under each aggregator of the top boundary
            # that fired, and the tier-1 aggregators' rows differ unless
            # the root fired
            W = H._subtree_width(hfl_s.tiers, 0, event["top"])
            leaves = tree_leaves(state.params)
            tops.append({"top": event["top"], "seconds": seconds,
                         "rows_identical_under_top": all(
                             torch.equal(P[n], P[(n // W) * W])
                             for P in leaves for n in range(n_s)),
                         "edges_differ": any(
                             not torch.equal(P[0], P[n_s - 1]) for P in leaves)})
            return
        if event.get("kind") in ("unit_sync", "push"):
            # after a root push the pushing unit's rows hold the fresh
            # root reference (one cast); a unit sync leaves its rows equal
            G = n_s // hfl_s.agg_count(1)
            rows = range(event["unit"] * G, (event["unit"] + 1) * G)
            leaves = tree_leaves(state.params)
            if event["kind"] == "push":
                ok = all(torch.equal(as_int(P[n]), as_int(R.to(P.dtype)))
                         for P, R in zip(leaves, tree_leaves(state.w_ref))
                         for n in rows)
            else:
                ok = all(torch.equal(P[n], P[rows[0]]) for P in leaves
                         for n in rows)
            unit_events.append({k: event.get(k) for k in (
                "kind", "unit", "tier", "agg", "round", "staleness", "weight",
                "seconds")} | {"rows_ok": ok})
            return
        # async: the active row is w_ref (dense downlink), or its value
        # after the event's last train step plus the received payload
        n = event["cluster"]
        if last["n"] != n:
            raise AssertionError(f"sim {name}: event of cluster {n} after "
                                 f"a train step of cluster {last['n']}")
        leaves = tree_leaves(state.params)
        if event["downlink"] is None:
            want = [R.to(P.dtype) for P, R in
                    zip(leaves, tree_leaves(state.w_ref))]
        else:
            dvals, didx = event["downlink"]
            idx = didx.long()
            order = torch.argsort(idx)
            sidx = idx[order]
            spec_s = fl.spec_of(state.w_ref)
            bounds = torch.searchsorted(sidx, torch.tensor(
                spec_s.offsets + (spec_s.total,), device=didx.device)).tolist()
            want = []
            for i, old in enumerate(last["row"]):
                w = old.clone().view(-1)
                a, b = bounds[i], bounds[i + 1]
                loc = sidx[a:b] - spec_s.offsets[i]
                w[loc] = (w[loc].float() + dvals[order[a:b]]).to(w.dtype)
                want.append(w.view(old.shape))
        if not all(torch.equal(as_int(P[n]), as_int(w))
                   for P, w in zip(leaves, want)):
            raise AssertionError(f"sim {name}: row {n} after its sync is "
                                 "not what the downlink sent")
        events.append({k: event[k] for k in (
            "cluster", "round", "staleness", "weight", "seconds",
            "bits_sbs_ul", "bits_mbs_dl")})

    def unchanged(before, after, what):
        if not all(torch.equal(as_int(a), as_int(b))
                   for a, b in zip(after, before)):
            raise AssertionError(f"sim {name}: {what}")

    def wrap(step_fn):  # lockstep/deadline: sat-out rows stay as they were
        def checked(state, batch, keep=None):
            out = [] if keep is None else [n for n in range(len(keep))
                                            if not keep[n]]
            leaves = tree_leaves(state.params) + tree_leaves(state.opt["m"])
            before = [P[n].clone() for n in out for P in leaves]
            state, loss = step_fn(state, batch, keep=keep)
            unchanged(before, [P[n] for n in out for P in leaves],
                      "a sat-out cluster's rows changed in a train step")
            sat_out.append(out)
            return state, loss
        return checked

    def wrap_masked(step_fn):  # async: only the event's cluster trains
        def checked(state, batch_n, n):
            leaves = tree_leaves(state.params) + tree_leaves(state.opt["m"])
            others = [m for m in range(n_s) if m != n]
            before = [P[m].clone() for m in others for P in leaves]
            last.clear()
            state, loss = step_fn(state, batch_n, n)
            masked.append(n)
            unchanged(before, [P[m] for m in others for P in leaves],
                      "another cluster's rows changed in a masked step")
            del before
            last.update(n=n, row=[P[n].clone() for P in tree_leaves(state.params)])
            return state, loss
        return checked

    free(torch)
    torch.cuda.reset_peak_memory_stats()
    since = LaunchCount(counters)
    retries0 = alloc_retries()
    out = train.run(args, on_sync=on_sync, wrap_train_step=wrap,
                    wrap_masked_step=wrap_masked)
    torch.cuda.synchronize()
    launches = since.read()
    peak = torch.cuda.max_memory_allocated()
    retries = alloc_retries() - retries0
    last.clear()
    card.by_path[f"sim {name} {impl}"] = launches
    if not scenario:
        check_async_root(card, name, args, hfl_s, out, launches, peak, sat_out,
                         unit_events)
        return None
    trace, eng = out["trace"], out["engine"]
    meta = trace.meta
    rec = {"argv": argv, "hist": out["hist"], "wallclock": trace.wallclock,
           "launches": launches, "peak_gb": peak / 1e9, "alloc_retries": retries}
    syncs_rows = [r for r in trace.rows if r["kind"] == "sync"]
    # every sync selects its rows' Ω once: N uplinks + 1 downlink under
    # lockstep (and the measured probe again before it), 1 + 1 per async
    # event with the sparse downlink, 1 with the dense one; a tiered
    # boundary one per child and one per aggregator of every tier that
    # fired (and the probe again under measured accounting)
    if asyn:
        n_omega = (1 + int(hfl_s.async_dl_sparse)) * len(syncs_rows)
    elif hier:
        n_omega = sum(hfl_s.agg_count(t - 1) + hfl_s.agg_count(t)
                      for r in syncs_rows for t in range(1, r["tier"] + 1))
        n_omega *= 2 if measured else 1
    else:
        n_omega = (n_s + 1) * (2 if measured else 1) * len(syncs_rows)
    want = {k: 0 for k in counters}
    for k in IMPL_KERNELS[impl]:
        want[k] = n_omega
    line = {"phase": "sim_path", "scenario": name, "impl": impl,
            "discipline": meta["discipline"], "accounting": meta["payload_accounting"],
            "residency": meta["residency"], "arch": cfg.name,
            "layers": args.layers or cfg.num_layers, "d_model": cfg.d_model,
            "clusters": n_s, "mus_per_cluster": hfl_s.mus_per_cluster,
            "fleet_mus": eng.fleet.K, "steps": STEPS, "syncs": len(syncs_rows),
            "sim_seed": args.sim_seed, "losses": out["hist"],
            "eval_loss": out["eval_loss"],
            "first_step_s": out["timing"]["compile_s"],
            "sync_ms": [1e3 * x for x in out["sync_s"]],
            "max_memory_allocated_gb": peak / 1e9, "alloc_retries": retries,
            "virtual_wallclock_s": trace.wallclock,
            "dropped_by_row": [r["dropped"] for r in trace.rows],
            "launches": launches, "launches_want": want, "card": card.smi}
    if asyn:
        # one on_step per event: its first is the first event's
        line.update(first_event_s=line.pop("first_step_s"), masked_steps=len(masked),
                    kinds=[r["kind"] for r in trace.rows], events=events)
    else:
        line.update(deadline_s=[r["deadline_s"] for r in syncs_rows],
                    sat_out_by_step=sat_out, rows_identical_after_sync=identical)
    if hier:
        line.update(sync_tiers=[r["tier"] for r in syncs_rows], cascades=tops)
    links = ("sbs_ul", "mbs_dl") + (("t2_ul", "t2_dl") if hier else ())
    if measured:
        line["ledger"] = {k: meta[k] for k in (
            "codec", "payload_size", "bits_per_param_mean",
            *(f"{x}_{l}" for l in links for x in ("bits", "events")))}
    if eng.residency is not None:
        # shards conserved; MUs whose cluster changed since the start
        eng.residency.check_conservation()
        line["reassociated"] = int((eng.residency.home != eng.fleet.cid).sum())
        if name == "scale-1m":
            # the run is shorter than the 600 virtual s between
            # repricings: move the fleet one interval on, as a longer
            # run would, and hold the 1.05M shards to conservation
            t_mv = time.perf_counter()
            eng._advance_fleet(eng.sim.reprice_interval_s)
            eng.residency.check_conservation()
            line["reassociated_after_one_interval"] = int(
                (eng.residency.home != eng.fleet.cid).sum())
            line["reprice_interval_host_s"] = time.perf_counter() - t_mv
    emit(line)
    if launches != want:
        raise AssertionError(f"sim {name}: launches {launches}, want {want}")
    if peak / 1e9 >= PEAK_LIMIT_GB:
        raise AssertionError(f"sim {name}: peak {peak / 1e9:.2f} GB")
    if not (math.isfinite(out["eval_loss"])
            and all(math.isfinite(l) for l in out["hist"])):
        raise AssertionError(f"sim {name}: non-finite loss")
    if asyn:
        rounds = STEPS // H_s
        if not (len(events) == len(syncs_rows) > 0
                and len(trace.rows) == n_s * rounds
                and len(masked) == H_s * len(syncs_rows)):
            raise AssertionError(f"sim {name}: {len(events)} events, "
                                 f"{len(masked)} masked steps, rows {line['kinds']}")
        if name == "async" and len(syncs_rows) != n_s * rounds:
            raise AssertionError(f"sim async: {len(syncs_rows)} syncs")
        if measured:  # the ledger's fronthaul = the events' own counts
            if not (meta["bits_sbs_ul"] == sum(e["bits_sbs_ul"] for e in events)
                    and meta["bits_mbs_dl"] == sum(e["bits_mbs_dl"] for e in events)
                    and meta["events_sbs_ul"] == meta["events_mbs_dl"]
                    == len(events)):
                raise AssertionError(f"sim {name}: ledger and event counts differ")
    elif hier:
        if not ([t["top"] for t in tops] == line["sync_tiers"] == [1, 2]
                and all(t["rows_identical_under_top"] for t in tops)
                and [t["edges_differ"] for t in tops] == [True, False]):
            raise AssertionError(f"sim {name}: tiered rows {tops}")
        if len(sat_out) != STEPS:
            raise AssertionError(f"sim {name}: sat-out steps {sat_out}")
        if name == "hier-deadline" and not any(r["dropped"] for r in trace.rows):
            raise AssertionError("sim hier-deadline: the deadline dropped no MU")
        if measured:  # every boundary's ledger links = the probe's counts
            for l in links:
                if meta[f"bits_{l}"] != sum(r.get(f"bits_{l}", 0.0)
                                            for r in syncs_rows):
                    raise AssertionError(f"sim {name}: ledger {l} != probe")
            if not (meta["events_sbs_ul"] == n_s * len(syncs_rows)
                    and meta["events_t2_ul"] == hfl_s.agg_count(1)
                    and meta["events_t2_dl"] == 1):
                raise AssertionError(f"sim {name}: ledger events {line['ledger']}")
    else:
        if not (len(identical) == len(syncs_rows) == STEPS // H_s
                and all(identical)):
            raise AssertionError(f"sim {name}: cluster rows differ after a sync")
        if len(sat_out) != STEPS or (name == "dropout" and not any(sat_out)):
            raise AssertionError(f"sim {name}: sat-out steps {sat_out}")
        if name == "stragglers" and not any(r["dropped"] for r in trace.rows):
            raise AssertionError("sim stragglers: the deadline dropped no MU")
        if measured:  # the ledger's fronthaul = the probe's host counts
            if not (meta["bits_sbs_ul"] == sum(r["bits_sbs_ul"] for r in syncs_rows)
                    and meta["bits_mbs_dl"] == sum(r["bits_mbs_dl"] for r in syncs_rows)
                    and meta["events_sbs_ul"] == n_s * len(syncs_rows)
                    and meta["events_mbs_dl"] == len(syncs_rows)):
                raise AssertionError(f"sim {name}: ledger and probe counts differ")
    if args.trace_viz:  # the obs outputs of the run (hier-3tier)
        emit({"phase": "sim_path_obs", "scenario": name,
              **check_obs_outputs(name, args, out, eng)})
    if name == "trace-replay" and not line["reassociated"]:
        raise AssertionError("sim trace-replay: no MU re-associated")
    if name == "scale-1m" and not line["reassociated_after_one_interval"]:
        raise AssertionError("sim scale-1m: no MU re-associated in an interval")
    return rec


def sim_path(torch, card):
    """Phase 7: the simulator's path, nine runs (``SIM_RUNS``) through
    ``repro_torch.launch.train`` (``sim.scenarios.build_engine`` and
    ``SimEngine.run``, or ``core.schedule.run_hfl``) at full olmo-1b width,
    4 steps: ``paper-fig3`` (lockstep, 7 x 4 MUs, H = 2, ``FIG3_LAYERS``
    layers, ``pallas`` Ω, measured accounting with ``delta-varint``),
    ``stragglers`` (deadline, ``2x2:H=2``, full depth, ``fused`` Ω: the
    deadline drops a straggler), ``dropout`` (lockstep with participation
    resampling, ``pallas`` Ω: a cluster sits out each round), ``async``
    (``pallas`` Ω, sparse downlink, measured ``delta-varint``),
    ``trace-replay`` (async over a replayed trace with ``move`` residency,
    ``fused`` Ω: an MU re-associates within the run) and ``scale-1m``
    (async, the live 1.05M-MU fleet behind 7 x 4 slots, ``pallas`` Ω,
    ``SCALE_LAYERS`` layers), then the depth-3 trees (2 edges x 2 SBSs x 4
    MUs, ``HIER_LAYERS`` layers, ``pallas`` Ω): ``hier-3tier`` (measured
    ``delta-varint``, the hier probe; tops 1 and 2, 30 launches each),
    ``hier-deadline`` (an MU is dropped; 15 launches) and the async-root
    tree ``--tiers 2x2x4:H=2,2:async`` without a scenario (the unit
    scheduler through ``run_hfl``: 4 unit syncs and 2 root pushes, 14
    launches), checking the rows identical under each aggregator of the
    top that fired, each pushing unit's rows equal to the new root
    reference, the ledger's per-boundary links equal to the probe's counts,
    and every peak under ``PEAK_LIMIT_GB``. The lockstep/deadline runs check
    the cluster rows identical after every sync and a sat-out cluster's
    params and momentum rows bitwise unchanged by a train step; the async
    runs check every masked step leaves the other clusters' params and
    momentum rows bitwise unchanged and, after each event's sync, the active
    row equal to its value before plus the received payload; all check
    finite losses and every kernel's launches against the count the trace
    implies, paper-fig3 and async the ledger's fronthaul bits against the
    probe's (the events') counts, and the residency runs the shards'
    conservation and a re-association (``scale-1m`` after moving its fleet
    one 600 s repricing interval on, since the run is shorter); each prints
    sync ms, peak memory, the virtual wall-clock and the drops (and, async,
    the staleness and weight) per trace row. ``hier-3tier`` also writes its
    ``--trace-viz`` export and ``--metrics-out`` run log (into
    ``OBS_DIR``), which must validate, pass ``tools/trace_summary.py
    --check`` (span bits = the tracer's books = the ledger's on every tier
    boundary's links) and agree with the registry's launch and ``comm.bits``
    totals. -> paper-fig3's record (phase 8a runs it again)."""
    t7 = time.perf_counter()
    records = {run[0]: sim_run(torch, card, *run) for run in SIM_RUNS}
    emit({"phase": "sim_path_done", "seconds": time.perf_counter() - t7})
    free(torch)
    return records["paper-fig3"]


# ---- phase 8: the obs path -----------------------------------------------------
def obs_path(torch, card, fig3=None):
    """Phase 8: the obs path (``repro_torch.obs`` through the train CLI's
    flags). (a) phase 7's paper-fig3 run again (``fig3``, its record; called
    alone, it makes it itself) with ``--obs-health --trace-viz --metrics-out
    --obs-heartbeat 1``: its losses bit for bit, virtual wall clock and
    ``update_max``/``tail_hist`` launches equal to phase 7's, the health
    ingest's host seconds per sync, no anomaly, the health counter tracks in
    the trace, the outputs checked as hier-3tier's; (b) ``async``
    (``2x2:H=2``, ``OBS_LAYERS`` layers, measured ``delta-varint``) with
    ``--obs-health --metrics-out``: per-cluster statistics finite, the
    ``sim.staleness`` histogram per cluster, conservation exact, 2 launches
    per event, the peak; (c) scenario-free ``2x2:H=2`` at ``OBS_LAYERS``
    layers with ``--obs-hlo-cost --metrics-out``: the first train step's and
    sync's flops, bytes and profiler launch counts, the train flops beside
    6 · params · tokens, the losses equal to the same run without the
    flag."""
    counters = sync_kernels()
    t8 = time.perf_counter()
    obs_retries = [0]

    def obs_run(argv, monitor_method=None, on_sync=None):
        """train.run(argv) on the card -> (args, out, its launches, peak
        bytes, host seconds of each ``HealthMonitor.<monitor_method>``
        call); the allocator's retries (a full cache freed and allocated
        again) go to ``obs_retries``."""
        free(torch)
        torch.cuda.reset_peak_memory_stats()
        since = LaunchCount(counters)
        obs_retries[:] = [alloc_retries()]
        args = train.parse_args(argv)
        if monitor_method is None:
            out, ingest = train.run(args, on_sync=on_sync), []
        else:
            with method_timer(torch, HealthMonitor, monitor_method) as mt:
                out = train.run(args, on_sync=on_sync)
            ingest = mt.seconds
        torch.cuda.synchronize()
        obs_retries[:] = [alloc_retries() - obs_retries[0]]
        return args, out, since.read(), torch.cuda.max_memory_allocated(), ingest

    def finite_losses(what, out):
        if not (math.isfinite(out["eval_loss"])
                and all(math.isfinite(l) for l in out["hist"])):
            raise AssertionError(f"obs {what}: non-finite loss")

    # 8a. paper-fig3 exactly as phase 7 ran it, with every telemetry flag on
    if fig3 is None:
        fig3 = sim_run(torch, card, *SIM_RUNS[0])
    identical = []
    args, out, launches, peak, ingest = obs_run(
        fig3["argv"] + ["--obs-health", "--trace-viz", str(OBS_DIR / "paper-fig3.json"),
                        "--metrics-out", str(OBS_DIR / "paper-fig3.jsonl"),
                        "--obs-heartbeat", "1"],
        "ingest_sync_stats",
        on_sync=lambda i, st, sec: identical.append(rows_identical(torch, st)))
    card.by_path["obs paper-fig3 pallas"] = launches
    info = check_obs_outputs("paper-fig3", args, out, out["engine"])
    hs = out["telemetry"].health.summary()
    emit({"phase": "obs_path", "run": "8a paper-fig3", "argv_added": [
              "--obs-health", "--trace-viz", "--metrics-out", "--obs-heartbeat 1"],
          "losses": out["hist"], "losses_equal_phase7": out["hist"] == fig3["hist"],
          "virtual_wallclock_s": out["trace"].wallclock,
          "alloc_retries": obs_retries[0], "alloc_retries_phase7": fig3["alloc_retries"],
          "health_ingest_s_per_sync": ingest, "health_summary": hs,
          "max_memory_allocated_gb": peak / 1e9, "launches": launches,
          "rows_identical_after_sync": identical, "card": card.smi, **info})
    if out["hist"] != fig3["hist"] or out["trace"].wallclock != fig3["wallclock"]:
        raise AssertionError("obs paper-fig3: the losses or the virtual clock "
                             "differ from the same run without telemetry")
    for k in ("update_max", "tail_hist"):
        if launches[k] != fig3["launches"][k]:
            raise AssertionError(f"obs paper-fig3: {k} launched {launches[k]} "
                                 f"times, {fig3['launches'][k]} without telemetry")
    want_tracks = {"health.drift", "health.residual", "health.loss",
                   "health.omega_overlap"}
    if not (hs["anomalies"] == 0 and hs["signals"]
            and want_tracks <= set(info["counter_tracks"])
            and len(ingest) == len(identical) == STEPS // PERIOD and all(identical)):
        raise AssertionError(f"obs paper-fig3: health {hs}, tracks "
                             f"{info['counter_tracks']}, ingest {ingest}")
    if peak / 1e9 >= PEAK_LIMIT_GB:
        raise AssertionError(f"obs paper-fig3: peak {peak / 1e9:.2f} GB")
    finite_losses("paper-fig3", out)
    del out

    # 8b. async (measured delta-varint, sparse downlink) with the health
    # monitor: per-cluster statistics from the async sync at OBS_LAYERS
    argv = (["--full", "--scenario", "async", "--omega-impl", "pallas",
             "--batch-per-mu", "4", "--seq", "128", "--steps", str(STEPS),
             "--log-every", "1", "--device", "cuda", "--tiers",
             f"{N_CLUSTERS}x2:H={PERIOD}", "--layers", str(OBS_LAYERS),
             "--payload-accounting", "measured", "--codec", "delta-varint",
             "--obs-health", "--metrics-out", str(OBS_DIR / "async.jsonl")])
    args, out, launches, peak, ingest = obs_run(argv, "ingest_async_sync_stats")
    card.by_path["obs async pallas"] = launches
    info = check_obs_outputs("async", args, out, out["engine"])
    snap = out["telemetry"].registry.snapshot()
    syncs_rows = [r for r in out["trace"].rows if r["kind"] == "sync"]
    stats = {k: snap[k]["series"] for k in (
        "health.drift", "health.eps_norm", "health.resid_ratio",
        "health.update_ratio", "health.staleness") if k in snap}
    stale = snap.get("sim.staleness", {}).get("series", {})
    emit({"phase": "obs_path", "run": "8b async", "layers": OBS_LAYERS,
          "losses": out["hist"], "syncs": len(syncs_rows),
          "virtual_wallclock_s": out["trace"].wallclock,
          "health_ingest_s_per_sync": ingest, "health_stats": stats,
          "staleness_histogram": stale, "health_summary":
              out["telemetry"].health.summary(),
          "max_memory_allocated_gb": peak / 1e9, "launches": launches,
          "card": card.smi, **info})
    clusters = {f"cluster=c{n}" for n in range(N_CLUSTERS)}
    if not (set(stats.get("health.drift", {})) == clusters
            and all(math.isfinite(v) for series in stats.values()
                    for v in series.values())
            and set(stale) == clusters and len(ingest) == len(syncs_rows) > 0):
        raise AssertionError(f"obs async: statistics {stats}, staleness {stale}")
    want = 2 * len(syncs_rows)  # uplink and sparse downlink Ω per event
    if launches["update_max"] != want or launches["tail_hist"] != want:
        raise AssertionError(f"obs async: launches {launches}, want {want} each")
    if peak / 1e9 >= PEAK_LIMIT_GB:
        raise AssertionError(f"obs async: peak {peak / 1e9:.2f} GB")
    finite_losses("async", out)
    del out

    # 8c. scenario-free --obs-hlo-cost: the first train step's and the first
    # sync's flops, bytes and launches, counted as they run; the losses are
    # those of the same run without the flag
    argv = MAIN_ARGV + ["--omega-impl", "pallas", "--layers", str(OBS_LAYERS)]
    _, plain, _, _, _ = obs_run(argv)
    args, out, launches, peak, _ = obs_run(
        argv + ["--obs-hlo-cost", "--metrics-out", str(OBS_DIR / "hlo_cost.jsonl")])
    card.by_path["obs hlo-cost pallas"] = launches
    costs = {}
    for line in Path(args.metrics_out).read_text().splitlines():
        rec = json.loads(line)
        if rec["event"] == "hlo_cost":
            costs[rec["fn"]] = {k: rec[k] for k in (
                "flops", "hbm_bytes", "collective_bytes", "launches")}
    n_params = fl.spec_of(init_model(None, olmo_config(OBS_LAYERS), device="meta")).total
    tokens = N_CLUSTERS * 2 * 4 * 128  # clusters x MUs x batch x sequence
    analytic = 6.0 * n_params * tokens
    emit({"phase": "obs_path", "run": "8c hlo-cost", "layers": OBS_LAYERS,
          "costs": costs, "params": n_params, "tokens": tokens,
          "six_params_tokens": analytic,
          "train_flops_over_6PT": costs.get("train_step", {}).get("flops", 0.0)
          / analytic, "losses": out["hist"],
          "losses_equal_without_flag": out["hist"] == plain["hist"],
          "max_memory_allocated_gb": peak / 1e9, "launches": launches,
          "card": card.smi})
    if set(costs) != {"train_step", "sync_step"} or not all(
            c["flops"] >= 0 and c["launches"] > 0 for c in costs.values()):
        raise AssertionError(f"obs hlo-cost: {costs}")
    if out["hist"] != plain["hist"] or out["eval_loss"] != plain["eval_loss"]:
        raise AssertionError("obs hlo-cost: counting the first calls changed "
                             "the run")
    want = (N_CLUSTERS + 1) * (STEPS // PERIOD)
    if launches["update_max"] != want or launches["tail_hist"] != want:
        raise AssertionError(f"obs hlo-cost: launches {launches}, want {want}")
    finite_losses("hlo-cost", out)
    del out, plain
    emit({"phase": "obs_path_done", "seconds": time.perf_counter() - t8})


# ---- phase 11: the kernel summary ---------------------------------------------
# every ported kernel: (its source, the reference code it stands for, the shape
# of the path it came with: the summary's headline numbers)
KERNEL_META = {
    "block_select": ("src/repro_torch/csrc/fused_sync.cu",
                     "src/repro/kernels/fused_sync/kernel.py:67", "olmo-1b"),
    "update_max": ("src/repro_torch/csrc/dgc.cu",
                   "src/repro/kernels/dgc/kernel.py:47", "olmo-1b"),
    "tail_hist": ("src/repro_torch/csrc/dgc.cu",
                  "src/repro/kernels/dgc/kernel.py:88", "olmo-1b"),
    "apply_mask": ("src/repro_torch/csrc/dgc.cu",
                   "src/repro/kernels/dgc/kernel.py:119", "resnet18"),
    "bitpack": ("src/repro_torch/csrc/bitpack.cu",
                "src/repro/kernels/bitpack/kernel.py:43", "resnet18"),
    # not TPU kernels: the reference's plain-jnp flash_attention
    "flash_attn_fwd": ("src/repro_torch/csrc/flash_attn.cu",
                       "src/repro/models/attention.py:23", "olmo-1b train_4k"),
    "flash_attn_bwd": ("src/repro_torch/csrc/flash_attn_bwd.cu",
                       "src/repro/models/attention.py:23", "olmo-1b train_4k"),
    # the reference's jnp decode_attention and mla_decode's latent einsums:
    # the CUDA-core kernels, then the tensor-core ones
    "decode_attn": ("src/repro_torch/csrc/decode_attn.cu",
                    "src/repro/models/attention.py:85", "olmo-1b decode_32k"),
    "mla_decode_attn": ("src/repro_torch/csrc/decode_attn.cu",
                        "src/repro/models/attention.py:252", "deepseek-v2 decode_32k"),
    "decode_attn_tc": ("src/repro_torch/csrc/decode_attn_sm90.cu",
                       "src/repro/models/attention.py:85", "granite-34b decode_32k"),
    "mla_decode_attn_tc": ("src/repro_torch/csrc/decode_attn_sm90.cu",
                           "src/repro/models/attention.py:252",
                           "deepseek-v2 decode_32k"),
    # no TPU kernel: the reference's lax.top_k (the exact fallback)
    "radix_select": ("src/repro_torch/csrc/radix_select.cu",
                     "src/repro/core/sparsify.py:pack_topk", "olmo-1b"),
    # no TPU kernel: the reference's jnp SGDM under jit (XLA fuses it)
    "sgdm": ("src/repro_torch/csrc/sgdm.cu", "src/repro/optim/sgd.py:SGDM", "olmo-1b"),
}


def all_kernels():
    """Every kernel wrapper of ``KERNEL_META`` by name."""
    return {**sync_kernels(), **attn_kernels(), "radix_select": RS.radix_select,
            "sgdm": SK.sgdm_update}


def kernel_summary(card, launched=None):
    """Phase 11: one JSON line listing every ported kernel with its launches
    on each path (and their sum), error, times and bound. In a whole run
    every kernel must have launched on some path and been timed at its
    first shape. For a phase run alone (``launched``: kernel -> its
    launches in that phase) it lists only the kernels that phase launched,
    with what it timed of them."""
    rows = []
    for name, (source, replaces, shape) in KERNEL_META.items():
        per_path = {p: c[name] for p, c in card.by_path.items() if c.get(name)}
        timed = card.kernels.get(name, {})
        if launched is None:
            if not per_path:
                raise AssertionError(f"{name} was launched on no path")
            k, launches = timed[shape], sum(per_path.values())
        elif launched[name]:
            k, launches = timed.get(shape, {}), launched[name]
        else:
            continue
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launches,
                     "launches_by_path": per_path,
                     **{f: k.get(f) for f in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                              "bound_by", "library_ms")},
                     "shape": shape, "shapes": timed})
    emit({"kernels": rows})


def alone(torch, phase):
    """Phase 1, then ``phase`` by itself, then the summary of the kernels it
    launched (see the module's docstring)."""
    card = setup(torch)
    since = LaunchCount(all_kernels())
    phase(torch, card)
    kernel_summary(card, since.read())


def main(argv):
    if argv:
        print("usage: python3 chip_smoke.py (no arguments; to run one phase, "
              "call chip_smoke.alone as the module's docstring says)", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 2
    card = setup(torch)
    for phase in (kernel_checks, fused_selection, radix_select_checks, sgdm_checks,
                  main_path):
        phase(torch, card)
        free(torch)
    comm_path(torch, card, sync_state=faithful_path(torch, card))
    obs_path(torch, card, fig3=sim_path(torch, card))
    for phase in (model_families, sharded_paths, checkpoint_and_dryrun, long_context,
                  long_decode):
        phase(torch, card)
    kernel_summary(card)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
