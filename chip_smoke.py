#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU: the quickest proof that
the port starts and computes the right thing on the card.

    python3 chip_smoke.py                # from the root of a checkout

Phases (each ends in ``torch.cuda.synchronize()``; any failure exits
nonzero):
  1. print the card's name and power limit; build the CUDA kernels from
     ``src/repro_torch/csrc`` and print the build seconds;
  2. hold every kernel against its plain PyTorch version on the card,
     bitwise, on edge cases and at the main path's shapes (one JSON line
     per check), and time kernel and plain version there;
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
  5. one JSON line listing every ported kernel with its launches on the
     main path, error, times and bound.
The last line is ``{"ok": true, "device": {...}}``. Without a CUDA device,
or without the rest of the repository, it exits nonzero and prints no
result. ``--profile DIR`` runs phase 4 under ``torch.profiler`` and writes
the device time by kernel to ``DIR/profile_{fused,pallas}.txt``, with the
device-busy share of the wall time (its timings then include the
profiler's overhead).
"""
import gc
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


def same(torch, got, want, what):
    """Fail unless the kernel's outputs equal the plain version's bitwise
    (NaN-free data; -0.0 == 0.0); returns the max abs difference, 0.0."""
    err = 0.0
    for g, w in zip(got, want):
        if g.shape != w.shape or g.dtype != w.dtype or not torch.equal(g, w):
            raise AssertionError(f"{what}: kernel and plain version differ")
        if g.numel():
            err = max(err, float((g.double() - w.double()).abs().max()))
    return err


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
        from repro_torch.configs import get_config
        from repro_torch.core import sparsify as sp
        from repro_torch.kernels import _build
        from repro_torch.kernels.dgc import kernel as DK
        from repro_torch.kernels.fused_sync import kernel as FK
        from repro_torch.kernels.fused_sync import ops as fops
        from repro_torch.launch import train
        from repro_torch.models.transformer import init_model
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

    # the main path's sizes, from the port's own model at full width
    cfg = get_config("olmo-1b")
    spec = fl.spec_of(init_model(None, cfg, device="meta"))  # shapes only
    Q = spec.total
    k_ul = sp.keep_count(Q, 0.9)
    emit({"phase": "sizes", "arch": cfg.name, "Q": Q, "k": k_ul})
    gen = torch.Generator(device=dev).manual_seed(0)
    rand = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    kernels = {}

    # ---- 2. kernels vs plain versions -------------------------------------
    BE = FK.BLOCK_ELEMS
    tiny = float(torch.finfo(torch.float32).tiny)
    cases = [("gaussian", rand(1 << 24), 1.5, 12000),
             ("ragged", rand(3 * BE - 777), 1.0, 24000),
             ("overflow", torch.ones(2 * BE, device=dev), 0.5, 128),
             ("all-zero", torch.zeros(BE + 5, device=dev), tiny, 64)]
    for name, x, th, cap in cases:
        n = x.numel()
        tht = torch.tensor([th], device=dev)
        got = FK.block_select(x, tht, cap, n)
        torch.cuda.synchronize()
        err = same(torch, got, FK.block_select_plain(x, tht, cap, n),
                   f"block_select[{name}]")
        emit({"check": "block_select", "case": name, "n": n, "cap_blk": cap,
              "bitwise_equal": True, "max_abs_err": err})
    del cases, x, got
    free(torch)

    def check_update_max(n, main_shape):
        rows = -(-n // (256 * 1024)) * 256
        v = rand(rows, 1024)
        if main_shape:  # the main path calls it with u = g = 0, sigma = 0
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
        if not main_shape:
            return
        del got
        ms = cuda_ms(torch, lambda: DK.update_max(u, v, g, sigma), 5)
        plain_ms = cuda_ms(torch, lambda: DK.update_max_plain(u, v, g, sigma), 1)
        P = rows * 1024
        # each distinct input read once (the main path passes u and g as
        # ONE zero buffer), u' and v' written once, 3 flops per element
        n_in = len({t.data_ptr() for t in (u, v, g)})
        b, by = bound_ms(4 * P * n_in + 8 * P + 4 * (rows // 256), 3 * P)
        kernels["update_max"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b,
                                     bound_by=by, library_ms=None,
                                     max_abs_err=err, elements=P)

    def check_tail_hist(n, main_shape):
        rows = -(-n // (256 * 1024)) * 256
        v = rand(rows, 1024)
        edges = sp.linear_edges(v.abs().max(), 64).clamp_min(tiny)
        got = DK.tail_hist(v, edges)
        torch.cuda.synchronize()
        err = same(torch, [got], [DK.tail_hist_plain(v, edges)], f"tail_hist[{n}]")
        emit({"check": "tail_hist", "n": n, "rows": rows, "bins": 64,
              "bitwise_equal": True, "max_abs_err": err,
              "count_at_edge0": float(got[0])})
        if not main_shape:
            return
        ms = cuda_ms(torch, lambda: DK.tail_hist(v, edges), 5)
        plain_ms = cuda_ms(torch, lambda: DK.tail_hist_plain(v, edges), 1)
        P = rows * 1024
        b, by = bound_ms(4 * P + 8 * 64, 7 * P)
        kernels["tail_hist"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b,
                                    bound_by=by, library_ms=None,
                                    max_abs_err=err, elements=P)

    for n, main_shape in (((1 << 24) + 12345, False), (Q, True)):
        check_update_max(n, main_shape)
        free(torch)
        check_tail_hist(n, main_shape)
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
    cap = fops.candidate_capacity(Q, k_ul)
    th = fops._row_threshold(S, k_ul, bins=128, sample=16384, margin=2)
    nb = -(-Q // BE)
    per = -(-cap // nb)
    cap_blk = min(BE, per + per // 4 + 64)
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
    plain_ms = cuda_ms(torch, lambda: FK.block_select_plain(row, th[0:1], cap_blk, Q), 1)
    b, by = bound_ms(4 * Q + 8 * nb * cap_blk + 4 * nb + 4, 2 * Q)
    kernels["block_select"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b,
                                   bound_by=by, library_ms=None, max_abs_err=err,
                                   elements=Q, cap_blk=cap_blk)
    del S, row, th
    free(torch)

    # ---- 4. the main path ---------------------------------------------------
    counters = {"block_select": FK.block_select, "update_max": DK.update_max,
                "tail_hist": DK.tail_hist}
    path_kernels = {"fused": ("block_select",), "pallas": ("update_max", "tail_hist")}
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
            kernels[name]["launches"] = launches[name]
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

    # ---- 5. kernel summary --------------------------------------------------
    meta = {
        "block_select": ("src/repro_torch/csrc/fused_sync.cu",
                         "src/repro/kernels/fused_sync/kernel.py:67"),
        "update_max": ("src/repro_torch/csrc/dgc.cu",
                       "src/repro/kernels/dgc/kernel.py:47"),
        "tail_hist": ("src/repro_torch/csrc/dgc.cu",
                      "src/repro/kernels/dgc/kernel.py:88"),
    }
    rows = []
    for name, (source, replaces) in meta.items():
        k = kernels[name]
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": k["launches"],
                     "max_abs_err": k["max_abs_err"], "ms": k["ms"],
                     "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
                     "bound_by": k["bound_by"], "library_ms": k["library_ms"]})
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
