#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU: the quickest proof that
the port starts and computes the right thing on the card.

    python3 chip_smoke.py                # from the root of a checkout

Phases (each ends in ``torch.cuda.synchronize()``; any failure exits
nonzero):
  1. print the card's name and power limit; build the CUDA kernels from
     ``src/repro_torch/csrc`` and print the build seconds and each kernel's
     registers, spills and shared memory (``-Xptxas -v``);
  2. hold every kernel against its plain PyTorch version on the card,
     bitwise, on edge cases and at the paths' shapes (one JSON line per
     check), and time kernel and plain version there; ``block_select`` on
     the boundaries of its design (``cap_blk`` at, one before and one after
     a warp's and a CTA's span, 1 and ``BLOCK_ELEMS``; a length ending
     inside a span of the last tile; a tile of candidates only; NaN and
     ±inf entries), ``tail_hist`` on elements equal to edges, NaN/±inf/±0,
     collapsed edges, 1, 64 and 256 bins, 3 and 5 tiles and the real
     ResNet-18 gradient, which is timed beside the gaussian with the device
     time of its two passes (slice counts, ordered sum) from a short
     ``torch.profiler`` capture; ``apply_mask`` is
     compared as bit patterns (signs of zeros included), and
     ``omega_pallas``/``dgc_step_pallas`` on the card against the same
     functions on CPU copies at one row of the faithful path's Q; so is
     the fused Ω there (``sparsify.omega(impl="fused")``), with
     ``block_select`` against its plain version at that row's own tile
     capacity and threshold, on a real full-width ResNet-18 gradient
     (more candidates than the buffer holds), randn**3 (heavy-tailed, the
     candidates answer) and a gaussian scaled up along the row (the
     total fits, the last tiles overflow); the branch the kernel's tile
     counts decide must be the one the card's selection took;
     ``bitpack`` against its plain version (bytes and popcounts) on edge
     cases (n = 5, a ragged two-block n, NaN/±0/±inf/subnormal entries,
     all-zero and all-one masks), on its design's boundaries (one tile,
     43 tiles, bits on both sides of every chunk and CTA span of three
     tiles) and at the comm path's and olmo-1b's shapes, with the
     occupancy calculator's clusters at once and the waves they make; and
     ``block_select``, ``update_max``, ``tail_hist`` and ``bitpack`` timed
     at one row of the faithful path's Q with the L2 cache flushed before
     every launch (the row fits in the 50 MB L2), each after a flush that
     writes and after one that reads (``bitpack`` also beside the events'
     own floor);
  3. fused selection on a gaussian [2, Q] matrix: ``select_topk_rows``
     (the ``block_select`` pipeline, which must answer it without the
     exact fallback) against the exact stable sort, timed
     beside ``torch.topk`` as the library yardstick;
  4. the main path: full-width olmo-1b through ``repro_torch.launch.train``
     at ``--full --tiers 2x2:H=2 --sync sparse --batch-per-mu 4 --seq 128``
     for 4 steps (2 syncs), once with ``--omega-impl fused`` and once with
     ``--omega-impl pallas``; launch counts are zeroed just before and read
     just after each run, and the fused run says how many of its
     selections the ``block_select`` candidates answered and how many the
     exact fallback answered;
  5. the paper-exact path: full-width ResNet-18 under ``FaithfulHFL``
     through ``repro_torch.launch.paper_accuracy.run`` at the paper's
     geometry (7 clusters x 4 MUs, H = 4, φ = (0.99, 0.9, 0.9, 0.9),
     β_s = 0.5, β_m = 0.2, σ = 0.9), batch 64 per MU, lr 0.05, 8 steps
     (2 syncs), once with ``--omega-impl pallas`` and once with ``fused``;
     every Ω row is one launch, (K + N)·S + (2N + 1)·⌊S/H⌋ = 310 of each
     kernel of the impl, counts zeroed just before each run; after every
     step every row of u and v must hold >= k zeros; the fused run says
     which selections the ``block_select`` candidates answered, by hop;
     the pallas run keeps its state after step 7, the one before the
     second sync;
  6. the comm path on that state, as an ``HFLState`` over the ResNet-18
     tree at 7 clusters (φ = 0.9 up and down, β_s = 0.5, β_m = 0.2):
     ``comm.make_sync_probe`` for every registered codec with ``pallas``
     and ``fused`` Ω; the pallas probe's 7 uplink and 1 downlink payloads
     bit-equal to the same probe on a CPU copy, the state unchanged,
     ``make_sync`` on a copy of the state sending each impl's probed
     payloads (w_ref and eps bit for bit),
     device bit counts equal to the host ``measure_bits``, the bitmap
     streams through ``bitpack`` equal to numpy's and decoding back,
     ``bitmap_payload`` of the downlink card = CPU, a ``PayloadLedger``
     per codec beside the analytic 32·(1 - φ), ``bitpack`` launched once
     per kernel-path encode and ``bitmap_payload`` call, the
     ``launch.comm_bits`` entry point on the card, and the async
     per-cluster sync (``sim.engine.make_async_sync_step``, sparse
     downlink, cluster 3) with ``pallas`` and ``fused`` Ω on the card
     against a CPU copy: w_ref, eps[n], e_dl[n], row n and the device bit
     counts equal, two launches of each kernel of the impl;
  7. the simulator's path, six runs through ``repro_torch.launch.train``
     with ``--scenario`` (``sim.scenarios.build_engine`` and
     ``SimEngine.run``) at full olmo-1b width, 4 steps:
     ``paper-fig3`` (lockstep, 7 x 4 MUs, H = 2, ``FIG3_LAYERS`` layers,
     ``pallas`` Ω, measured accounting with ``delta-varint``),
     ``stragglers`` (deadline, ``2x2:H=2``, full depth, ``fused`` Ω,
     ``--sim-seed 3``: the deadline drops a straggler), ``dropout``
     (lockstep with participation resampling, ``2x2:H=2``, full depth,
     ``pallas`` Ω, ``--sim-seed 8``: a cluster sits out each round),
     ``async`` (``2x2:H=2``, full depth, ``pallas`` Ω, sparse downlink,
     measured ``delta-varint``), ``trace-replay`` (async over a replayed
     trace with ``move`` residency, ``2x2:H=2``, full depth, ``fused`` Ω,
     ``--sim-seed 25``: an MU re-associates within the run) and
     ``scale-1m`` (async, the live 1.05M-MU fleet behind 7 x 4 slots,
     ``pallas`` Ω, ``SCALE_LAYERS`` layers); the lockstep/deadline runs
     check the cluster rows identical after every sync and a sat-out
     cluster's params and momentum rows bitwise unchanged by a train step;
     the async runs check every masked step leaves the other clusters'
     params and momentum rows bitwise unchanged and, after each event's
     sync, the active row equal to its value before plus the received
     payload; all check finite losses and every kernel's launches against
     the count the trace implies, paper-fig3 and async the ledger's
     fronthaul bits against the probe's (the events') counts, and the
     residency runs the shards' conservation and a re-association
     (``scale-1m`` after moving its fleet one 600 s repricing interval
     on, since the run is shorter); each prints steady s/step, sync ms,
     peak memory, the virtual wall-clock and the drops (and, async, the
     staleness and weight) per trace row;
  8. one JSON line listing every ported kernel with its launches on each
     path (and their sum), error, times and bound.
The last line is ``{"ok": true, "device": {...}}``. Without a CUDA device,
or without the rest of the repository, it exits nonzero and prints no
result. ``--profile DIR`` runs phases 4 and 5 under ``torch.profiler`` and
writes the device time by kernel to ``DIR/profile_{fused,pallas}.txt`` and
``DIR/profile_faithful_{pallas,fused}.txt``, with the device-busy share of
the wall time (its timings then include the profiler's overhead).
"""
import dataclasses
import gc
import itertools
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
F32_FLOPS = 67e12          # H100 SXM float32 outside the tensor cores
N_CLUSTERS, STEPS, PERIOD = 2, 4, 2
# kernel functions of csrc/*.cu, as the build log names them
KERNEL_FUNCTIONS = ("select_kernel", "update_max_kernel", "slice_hist_kernel",
                    "tile_order_sum_kernel", "apply_mask_kernel", "bitpack_kernel")
# block_select's spans (csrc/fused_sync.cu): a warp's and a CTA's share of a tile
SELECT_WARP_SPAN, SELECT_CTA_SPAN = 1024, 8192
# bitpack's design (csrc/bitpack.cu): CTAs per tile, elements per chunk
BP_CTAS, BP_CHUNK = 8, 4096
F_STEPS, F_LR = 8, 0.05  # the paper-exact path: 2 syncs, the example's lr
FIG3_LAYERS = 6  # paper-fig3's depth cut: 7 clusters' state at full width
# scale-1m's depth cut: 7 clusters' async state (e_dl included) and the
# masked-step check's copies of the 6 idle rows pass the card at 6 layers
SCALE_LAYERS = 4
TRACE_SEED = 25  # trace-replay: an MU re-associates within the 4 steps
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


def kernel_split(torch, fn, reps, flush=None):
    """Mean device ms per call of each named kernel that ``fn`` launches,
    from a short torch.profiler capture (``flush`` rewritten before each
    call evicts the L2; its own kernel is not counted)."""
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
    return {k: sum(getattr(e, key) for e in avg if k in e.key) / reps / 1e3
            for k in ("slice_hist_kernel", "tile_order_sum_kernel")}


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


def free(torch):
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def profiled(torch, fn, path):
    """Run ``fn`` under torch.profiler; write the kernel table to ``path``
    and print the device-busy share of the wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    avg = prof.key_averages()
    key = "self_device_time_total"
    if not hasattr(next(iter(avg)), key):
        key = "self_cuda_time_total"
    busy_us = sum(getattr(e, key) for e in avg if e.device_type == DeviceType.CUDA)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(avg.table(sort_by=key, row_limit=40))
    emit({"profile": path.name, "wall_s": wall, "device_busy_s": busy_us / 1e6,
          "device_idle_share": 1.0 - busy_us / 1e6 / wall})
    return out


def main(argv):
    import torch

    profile_dir = None
    if argv[:1] == ["--profile"] and len(argv) == 2:
        profile_dir = Path(argv[1]).resolve()
    elif argv:
        print("usage: python3 chip_smoke.py [--profile DIR]", file=sys.stderr)
        return 2

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 2
    try:
        import numpy as np

        from repro_torch.comm import accounting as acc
        from repro_torch.comm import codecs as cod
        from repro_torch.configs import get_config
        from repro_torch.configs.resnet18_cifar import CONFIG as PAPER
        from repro_torch.core import sparsify as sp
        from repro_torch.core import hfl as H
        from repro_torch.core.hfl import HFLState
        from repro_torch.data import SyntheticImages
        from repro_torch.kernels import _build
        from repro_torch.kernels.bitpack import kernel as BK
        from repro_torch.kernels.bitpack import ops as bops
        from repro_torch.kernels.dgc import kernel as DK
        from repro_torch.kernels.dgc import ops as dops
        from repro_torch.kernels.fused_sync import kernel as FK
        from repro_torch.kernels.fused_sync import ops as fops
        from repro_torch.launch import comm_bits
        from repro_torch.launch import paper_accuracy as pa
        from repro_torch.launch import train
        from repro_torch.models.resnet import init_resnet18
        from repro_torch.models.transformer import init_model
        from repro_torch.sim import engine as E
        from repro_torch.utils import flatten as fl
        from repro_torch.utils.tree import tree_leaves
    except ImportError as exc:
        print(f"chip_smoke: the repository's src/repro_torch is missing ({exc})",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # ---- 1. card and build ------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"phase": "build", "seconds": _build.timed_build(),
          "library": str(_build.library_path().relative_to(ROOT))})
    if _build.log_path().exists():  # absent when an earlier process built it
        emit({"phase": "ptxas",
              "kernels": ptxas_report(_build.log_path().read_text())})

    # the main path's sizes, from the port's own model at full width
    cfg = get_config("olmo-1b")
    spec = fl.spec_of(init_model(None, cfg, device="meta"))  # shapes only
    Q = spec.total
    k_ul = sp.keep_count(Q, 0.9)
    emit({"phase": "sizes", "arch": cfg.name, "Q": Q, "k": k_ul})
    # the faithful path's sizes: full-width ResNet-18, shapes only
    Qf = fl.spec_of(init_resnet18(None, width=PAPER.width, device="meta")[0]).total
    kf = sp.keep_count(Qf, PAPER.hfl.tiers[0].phi_up)  # the MU uplink's k
    emit({"phase": "sizes", "arch": "resnet18-cifar", "width": PAPER.width,
          "Q": Qf, "k": kf})
    gen = torch.Generator(device=dev).manual_seed(0)
    rand = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    kernels = {}  # kernel -> shape -> its check's error, times and bound
    flush = torch.empty(32 << 20, device=dev)  # 128 MB: evicts the 50 MB L2

    def timed(name, shape, ms, plain_ms, nbytes, nops, err, elements, **extra):
        b, by = bound_ms(nbytes, nops)
        kernels.setdefault(name, {})[shape] = entry = dict(
            ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by, library_ms=None,
            max_abs_err=err, elements=elements, **extra)
        emit({"timing": name, "shape": shape, **entry})

    # ---- 2. kernels vs plain versions -------------------------------------
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
        timed("update_max", shape, ms, plain_ms,
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
        timed("tail_hist", shape, ms, plain_ms, 4 * P + 8 * edges.numel(), 7 * P,
              err, P, data=case, slice_pass_ms=split["slice_hist_kernel"],
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
    timed("apply_mask", "resnet18", ms, plain_ms, 20 * P + 4, 3 * P, err, P)
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
    sel = fops.select_topk_rows
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
        n0 = len(sel.outcomes)
        sent, mask = sp.omega(x, phi_f, impl="fused")
        torch.cuda.synchronize()
        if sel.outcomes[n0:] != [answers]:
            raise AssertionError(f"omega fused[{name}]: took {sel.outcomes[n0:]}, "
                                 f"the tile counts decide {answers}")
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
            timed("block_select", "resnet18", ms, plain_ms,
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
        timed("bitpack", shape, ms, plain_ms, 4 * P + P // 8 + 4 * (P // BE_BP),
              P, 0.0, P, tiles=P // BE_BP, active_clusters=bp_clusters,
              waves=-(-(P // BE_BP) // bp_clusters), **extra)
        del tiles
        free(torch)

    # ---- 3. fused selection on [2, Q] -------------------------------------
    S = rand(N_CLUSTERS, Q)
    fb0 = fops.select_topk_rows.fallbacks
    vals, idx = fops.select_topk_rows(S, k_ul)
    torch.cuda.synchronize()
    took_kernel_path = fops.select_topk_rows.fallbacks == fb0
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
    nb = -(-Q // BE)
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
    timed("block_select", "olmo-1b", ms, plain_ms,
          4 * Q + 8 * nb * cap_blk + 4 * nb + 4, 2 * Q, err, Q, cap_blk=cap_blk,
          no_candidates_ms=ms_none)
    del S, row, th, no_th
    free(torch)

    # ---- 4. the main path ---------------------------------------------------
    counters = {"block_select": FK.block_select, "update_max": DK.update_max,
                "tail_hist": DK.tail_hist, "apply_mask": DK.apply_mask,
                "bitpack": BK.bitpack}
    path_kernels = {"fused": ("block_select",), "pallas": ("update_max", "tail_hist")}
    by_path = {}  # path -> {kernel: launches in that path's run}
    syncs = STEPS // PERIOD
    for impl in ("fused", "pallas"):
        identical = []

        def on_sync(i, state, seconds):
            identical.append(all(
                torch.equal(P[0], P[n]) for P in tree_leaves(state.params)
                for n in range(1, P.shape[0])))

        free(torch)
        torch.cuda.reset_peak_memory_stats()
        fin0, fb0 = fops.select_topk_rows.finished, fops.select_topk_rows.fallbacks
        for fn in counters.values():
            fn.launches = 0
        args = train.parse_args(MAIN_ARGV + ["--omega-impl", impl])
        if profile_dir is not None:
            out = profiled(torch, lambda: train.run(args, on_sync=on_sync),
                           profile_dir / f"profile_{impl}.txt")
        else:
            out = train.run(args, on_sync=on_sync)
        torch.cuda.synchronize()
        launches = {k: fn.launches for k, fn in counters.items()}
        peak = torch.cuda.max_memory_allocated()
        # which selections the block_select candidates answered, and which
        # the exact fallback answered after the kernel ran
        finished = fops.select_topk_rows.finished - fin0
        fallbacks = fops.select_topk_rows.fallbacks - fb0
        emit({"phase": "main_path", "impl": impl, "arch": cfg.name,
              "layers": cfg.num_layers, "d_model": cfg.d_model,
              "tiers": MAIN_ARGV[2], "steps": STEPS, "syncs": syncs,
              "losses": out["hist"], "eval_loss": out["eval_loss"],
              "steady_s_per_step": out["timing"]["steady_s_per_step"],
              "first_step_s": out["timing"]["compile_s"],
              "sync_ms": [1e3 * s for s in out["sync_s"]],
              "max_memory_allocated_gb": peak / 1e9, "launches": launches,
              "fused_selections": {"kernel_pipeline": finished,
                                   "exact_fallback": fallbacks},
              "rows_identical_after_sync": identical})
        want = (N_CLUSTERS + 1) * syncs
        for name in path_kernels[impl]:
            if launches[name] != want:
                raise AssertionError(f"{impl}: {name} launched {launches[name]} "
                                     f"times, want {want}")
        by_path[f"olmo-1b {impl}"] = launches
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

    # ---- 5. the paper-exact path --------------------------------------------
    hfl_f = PAPER.hfl  # 7 clusters x 4 MUs, H = 4, the paper's φ, β and σ
    K_f, N_f, period = hfl_f.total_mus, hfl_f.num_clusters, hfl_f.tiers[1].period
    f_syncs = F_STEPS // period
    want_f = (K_f + N_f) * F_STEPS + (2 * N_f + 1) * f_syncs
    f_kernels = {"pallas": ("update_max", "tail_hist", "apply_mask"),
                 "fused": ("block_select",)}
    sync_state = {}  # the pallas run's SBS/MBS buffers before its second sync
    for impl in ("pallas", "fused"):
        min_zeros = []

        def on_step(t, sim, metrics):
            min_zeros.append(min(int((sim.state[b] == 0).sum(dim=1).min())
                                 for b in ("u", "v")))
            if impl == "pallas" and t == F_STEPS - 2:
                sync_state.update({b: sim.state[b].clone() for b in
                                   ("w_tilde_n", "eps_n", "w_ref", "e")})

        free(torch)
        torch.cuda.reset_peak_memory_stats()
        for fn in counters.values():
            fn.launches = 0
        n0 = len(sel.outcomes)
        run = lambda: pa.run(f"faithful {impl}", hfl_f, F_STEPS,
                             batch_per_mu=PAPER.batch_per_mu, lr=F_LR, seed=0,
                             width=PAPER.width, device="cuda",
                             omega_impl=impl, on_step=on_step)
        if profile_dir is not None:
            out = profiled(torch, run, profile_dir / f"profile_faithful_{impl}.txt")
        else:
            out = run()
        torch.cuda.synchronize()
        launches = {k: fn.launches for k, fn in counters.items()}
        by_path[f"faithful {impl}"] = launches
        outcomes = sel.outcomes[n0:]
        if len(outcomes) != (want_f if impl == "fused" else 0):
            raise AssertionError(f"faithful {impl}: {len(outcomes)} fused "
                                 f"selections, want {want_f} with fused only")
        hops = split_by_hop(outcomes, F_STEPS, K_f, N_f, period)
        emit({"phase": "faithful_path", "impl": impl, "arch": "resnet18-cifar",
              "width": PAPER.width, "Q": Qf, "clusters": N_f,
              "mus_per_cluster": hfl_f.mus_per_cluster, "period": period,
              "batch_per_mu": PAPER.batch_per_mu, "lr": F_LR,
              "steps": F_STEPS, "syncs": f_syncs, "losses": out["losses"],
              "top1": out["acc"], "steady_s_per_step": out["steady_s_per_step"],
              "first_step_s": out["first_step_s"], "step_s": out["step_s"],
              "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
              "launches": launches, "min_zeros_per_row": min_zeros, "k": kf,
              "fused_selections_by_hop": hops if impl == "fused" else None})
        for name in f_kernels[impl]:
            if launches[name] != want_f:
                raise AssertionError(f"faithful {impl}: {name} launched "
                                     f"{launches[name]} times, want {want_f}")
        if len(min_zeros) != F_STEPS or min(min_zeros) < kf:
            raise AssertionError(f"faithful {impl}: a u/v row holds fewer than "
                                 f"k = {kf} zeros after a step: {min_zeros}")
        if not (math.isfinite(out["acc"]) and all(math.isfinite(l) for l in out["losses"])):
            raise AssertionError(f"faithful {impl}: non-finite loss or accuracy")
        if impl == "fused":
            print("faithful fused: selections answered from the block_select "
                  "candidates / by the exact fallback, by hop: " + ", ".join(
                      f"{h} {c['kernel_pipeline']}/{c['exact_fallback']}"
                      for h, c in hops.items()), flush=True)
        del out

    # ---- 6. the comm path on the faithful path's sync state ---------------
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
    for fn in counters.values():
        fn.launches = 0
    probe_bits, payloads = {}, {}
    for impl, cfg_i in comm_cfg.items():
        probe_bits[impl] = {}
        for name in names:
            ul, dl = acc.make_sync_probe(cfg_i, name)(state_d)
            probe_bits[impl][name] = [int(b) for b in ul] + [int(dl)]
        ups, down = acc.make_sync_probe(cfg_i, "bitmap").payloads(state_d)
        payloads[impl] = ups + [down]
    torch.cuda.synchronize()
    probe_launches = {k: fn.launches for k, fn in counters.items()}
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
    comm_launches = {k: fn.launches for k, fn in counters.items()}
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
    by_path["comm (ResNet-18 sync state)"] = comm_launches
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
    edl0 = 0.01 * rand(N_f, Qf)  # a downlink error with every entry set
    for fn in counters.values():
        fn.launches = 0
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
    async_launches = {k: fn.launches for k, fn in counters.items()}
    want_a = {k: 0 for k in counters}
    for impl in comm_cfg:  # one uplink and one downlink Ω per sync
        for k in path_kernels[impl]:
            want_a[k] = 2
    if async_launches != want_a:
        raise AssertionError(f"async sync: launches {async_launches}, want {want_a}")
    by_path["comm async sync (ResNet-18 sync state)"] = async_launches
    del edl0
    emit({"check": "async_sync", "Q": Qf, "clusters": N_f, "cluster": n_a,
          "weight": w_a, "dl_sparse": True, "card_equals_cpu_bit_patterns": True,
          "launches": async_launches, **async_check})
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
    del payloads, state_d, rows_d, sync_state
    free(torch)

    # ---- 7. the simulator's path -------------------------------------------
    # three scenario runs through the train CLI's build_engine + SimEngine.run
    # at full olmo-1b width; paper-fig3's 7 x 4 clusters at a depth cut (the
    # state of 7 full-depth clusters does not fit the card)
    from repro_torch.configs import HFLConfig, parse_tiers_spec
    from repro_torch.sim.scenarios import apply_hfl_overrides, get_scenario

    t7 = time.perf_counter()
    two = ["--tiers", f"{N_CLUSTERS}x2:H={PERIOD}"]
    sim_runs = (("paper-fig3", "pallas", ["--layers", str(FIG3_LAYERS),
                                          "--payload-accounting", "measured",
                                          "--codec", "delta-varint"]),
                # the seeds make the checks bite (the fleet is numpy, the
                # same on every machine): seed 3 drops a straggler in both
                # rounds, seed 8 has a cluster sit out each round, seed 25
                # re-associates an MU (and moves its shard) within the run
                ("stragglers", "fused", two + ["--sim-seed", "3"]),
                ("dropout", "pallas", two + ["--sim-seed", "8"]),
                ("async", "pallas", two + ["--payload-accounting", "measured",
                                           "--codec", "delta-varint"]),
                ("trace-replay", "fused", two + ["--sim-seed", str(TRACE_SEED)]),
                ("scale-1m", "pallas", ["--layers", str(SCALE_LAYERS)]))
    as_int = lambda x: x.view(torch.int16 if x.element_size() == 2 else torch.int32)
    for name, impl, extra in sim_runs:
        args = train.parse_args(
            ["--full", "--scenario", name, "--omega-impl", impl, "--batch-per-mu",
             "4", "--seq", "128", "--steps", str(STEPS), "--log-every", "1",
             "--device", "cuda"] + extra)
        scn = get_scenario(name)
        hfl_s = apply_hfl_overrides(scn, HFLConfig(
            tiers=parse_tiers_spec(args.tiers or "4x2:H=4")))
        n_s, H_s = hfl_s.num_clusters, hfl_s.tiers[1].period
        asyn = scn.sim.discipline == "async"
        measured = args.payload_accounting == "measured"
        identical, sat_out, events, step_s, last = [], [], [], [], {}

        def on_sync(i, state, seconds, event=None):
            if event is None:  # lockstep/deadline: every row is the consensus
                identical.append(all(
                    torch.equal(P[0], P[n]) for P in tree_leaves(state.params)
                    for n in range(1, P.shape[0])))
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
                    spec_s.offsets + (spec_s.total,), device=dev)).tolist()
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
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, loss = step_fn(state, batch_n, n)
                torch.cuda.synchronize()
                step_s.append(time.perf_counter() - t0)
                unchanged(before, [P[m] for m in others for P in leaves],
                          "another cluster's rows changed in a masked step")
                del before
                last.update(n=n, row=[P[n].clone() for P in tree_leaves(state.params)])
                return state, loss
            return checked

        free(torch)
        torch.cuda.reset_peak_memory_stats()
        for fn in counters.values():
            fn.launches = 0
        out = train.run(args, on_sync=on_sync, wrap_train_step=wrap,
                        wrap_masked_step=wrap_masked)
        torch.cuda.synchronize()
        launches = {k: fn.launches for k, fn in counters.items()}
        peak = torch.cuda.max_memory_allocated()
        last.clear()
        by_path[f"sim {name} {impl}"] = launches
        trace, eng = out["trace"], out["engine"]
        meta = trace.meta
        syncs_rows = [r for r in trace.rows if r["kind"] == "sync"]
        # every sync selects its rows' Ω once: N uplinks + 1 downlink under
        # lockstep (and the measured probe again before it), 1 + 1 per async
        # event with the sparse downlink, 1 with the dense one
        if asyn:
            per_sync = 1 + int(hfl_s.async_dl_sparse)
        else:
            per_sync = (n_s + 1) * (2 if measured else 1)
        want = {k: 0 for k in counters}
        for k in path_kernels[impl]:
            want[k] = per_sync * len(syncs_rows)
        line = {"phase": "sim_path", "scenario": name, "impl": impl,
                "discipline": meta["discipline"], "accounting": meta["payload_accounting"],
                "residency": meta["residency"], "arch": cfg.name,
                "layers": args.layers or cfg.num_layers, "d_model": cfg.d_model,
                "clusters": n_s, "mus_per_cluster": hfl_s.mus_per_cluster,
                "fleet_mus": eng.fleet.K, "steps": STEPS, "syncs": len(syncs_rows),
                "sim_seed": args.sim_seed, "losses": out["hist"],
                "eval_loss": out["eval_loss"],
                "steady_s_per_step": out["timing"]["steady_s_per_step"],
                "first_step_s": out["timing"]["compile_s"],
                "sync_ms": [1e3 * x for x in out["sync_s"]],
                "max_memory_allocated_gb": peak / 1e9,
                "virtual_wallclock_s": trace.wallclock,
                "dropped_by_row": [r["dropped"] for r in trace.rows],
                "launches": launches, "launches_want": want, "card": smi}
        if asyn:
            # one on_step per event: the per-step times are the masked
            # steps' own (device waited on before and after each)
            line.update(steady_s_per_step=(sum(step_s[1:]) / (len(step_s) - 1)
                                           if len(step_s) > 1 else None),
                        first_step_s=step_s[0] if step_s else None,
                        first_event_s=out["timing"]["compile_s"],
                        steady_s_per_event=out["timing"]["steady_s_per_step"],
                        masked_steps=len(step_s),
                        kinds=[r["kind"] for r in trace.rows], events=events)
        else:
            line.update(deadline_s=[r["deadline_s"] for r in syncs_rows],
                        sat_out_by_step=sat_out, rows_identical_after_sync=identical)
        if measured:
            line["ledger"] = {k: meta[k] for k in (
                "codec", "payload_size", "bits_sbs_ul", "bits_mbs_dl",
                "events_sbs_ul", "events_mbs_dl", "bits_per_param_mean")}
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
        if not (math.isfinite(out["eval_loss"])
                and all(math.isfinite(l) for l in out["hist"])):
            raise AssertionError(f"sim {name}: non-finite loss")
        if asyn:
            rounds = STEPS // H_s
            if not (len(events) == len(syncs_rows) > 0
                    and len(trace.rows) == n_s * rounds
                    and len(step_s) == H_s * len(syncs_rows)):
                raise AssertionError(f"sim {name}: {len(events)} events, "
                                     f"{len(step_s)} masked steps, rows {line['kinds']}")
            if name == "async" and len(syncs_rows) != n_s * rounds:
                raise AssertionError(f"sim async: {len(syncs_rows)} syncs")
            if measured:  # the ledger's fronthaul = the events' own counts
                if not (meta["bits_sbs_ul"] == sum(e["bits_sbs_ul"] for e in events)
                        and meta["bits_mbs_dl"] == sum(e["bits_mbs_dl"] for e in events)
                        and meta["events_sbs_ul"] == meta["events_mbs_dl"]
                        == len(events)):
                    raise AssertionError(f"sim {name}: ledger and event counts differ")
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
        if name == "trace-replay" and not line["reassociated"]:
            raise AssertionError("sim trace-replay: no MU re-associated")
        if name == "scale-1m" and not line["reassociated_after_one_interval"]:
            raise AssertionError("sim scale-1m: no MU re-associated in an interval")
        del out, trace, eng
    emit({"phase": "sim_path_done", "seconds": time.perf_counter() - t7})
    free(torch)

    # ---- 8. kernel summary --------------------------------------------------
    meta = {
        "block_select": ("src/repro_torch/csrc/fused_sync.cu",
                         "src/repro/kernels/fused_sync/kernel.py:67"),
        "update_max": ("src/repro_torch/csrc/dgc.cu",
                       "src/repro/kernels/dgc/kernel.py:47"),
        "tail_hist": ("src/repro_torch/csrc/dgc.cu",
                      "src/repro/kernels/dgc/kernel.py:88"),
        "apply_mask": ("src/repro_torch/csrc/dgc.cu",
                       "src/repro/kernels/dgc/kernel.py:119"),
        "bitpack": ("src/repro_torch/csrc/bitpack.cu",
                    "src/repro/kernels/bitpack/kernel.py:43"),
    }
    # the headline numbers at the shape of the path each kernel came with;
    # every shape timed under "shapes"
    first_shape = {"block_select": "olmo-1b", "update_max": "olmo-1b",
                   "tail_hist": "olmo-1b", "apply_mask": "resnet18",
                   "bitpack": "resnet18"}
    rows = []
    for name, (source, replaces) in meta.items():
        k = kernels[name][first_shape[name]]
        per_path = {p: c[name] for p, c in by_path.items() if c[name]}
        if not per_path:
            raise AssertionError(f"{name} was launched on no path")
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": sum(per_path.values()),
                     "launches_by_path": per_path,
                     "max_abs_err": k["max_abs_err"], "ms": k["ms"],
                     "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
                     "bound_by": k["bound_by"], "library_ms": k["library_ms"],
                     "shape": first_shape[name], "shapes": kernels[name]})
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
