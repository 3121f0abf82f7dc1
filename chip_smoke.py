#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU: the quickest proof that
the port starts and computes the right thing on the card.

    python3 chip_smoke.py                # from the root of a checkout

Phases (each ends in ``torch.cuda.synchronize()``; any failure exits
nonzero):
  1. print the card's name and power limit; build the CUDA kernels from
     ``src/repro_torch/csrc`` and print the build seconds;
  2. hold every kernel against its plain PyTorch version on the card,
     bitwise, on edge cases and at the paths' shapes (one JSON line per
     check), and time kernel and plain version there; ``apply_mask`` is
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
  6. one JSON line listing every ported kernel with its launches on each
     path (and their sum), error, times and bound.
The last line is ``{"ok": true, "device": {...}}``. Without a CUDA device,
or without the rest of the repository, it exits nonzero and prints no
result. ``--profile DIR`` runs phases 4 and 5 under ``torch.profiler`` and
writes the device time by kernel to ``DIR/profile_{fused,pallas}.txt`` and
``DIR/profile_faithful_{pallas,fused}.txt``, with the device-busy share of
the wall time (its timings then include the profiler's overhead).
"""
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
F_STEPS, F_LR = 8, 0.05  # the paper-exact path: 2 syncs, the example's lr
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
        from repro_torch.configs import get_config
        from repro_torch.configs.resnet18_cifar import CONFIG as PAPER
        from repro_torch.core import sparsify as sp
        from repro_torch.data import SyntheticImages
        from repro_torch.kernels import _build
        from repro_torch.kernels.dgc import kernel as DK
        from repro_torch.kernels.dgc import ops as dops
        from repro_torch.kernels.fused_sync import kernel as FK
        from repro_torch.kernels.fused_sync import ops as fops
        from repro_torch.launch import paper_accuracy as pa
        from repro_torch.launch import train
        from repro_torch.models.resnet import init_resnet18
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
    # the faithful path's sizes: full-width ResNet-18, shapes only
    Qf = fl.spec_of(init_resnet18(None, width=PAPER.width, device="meta")[0]).total
    kf = sp.keep_count(Qf, PAPER.hfl.tiers[0].phi_up)  # the MU uplink's k
    emit({"phase": "sizes", "arch": "resnet18-cifar", "width": PAPER.width,
          "Q": Qf, "k": kf})
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
    b, by = bound_ms(20 * P + 4, 3 * P)
    kernels["apply_mask"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b,
                                 bound_by=by, library_ms=None,
                                 max_abs_err=err, elements=P)
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
    phi_f = PAPER.hfl.tiers[0].phi_up
    sel = fops.select_topk_rows
    cap_f = fops.candidate_capacity(Qf, kf)
    cap_blk_f = fops.tile_capacity(Qf, cap_f)
    ramp = torch.arange(Qf, device=dev, dtype=torch.float32) / Qf
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
    del grad, ramp, x, th, got, sent, mask, want_sent, want_mask
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
    plain_ms = cuda_ms(torch, lambda: FK.block_select_plain(row, th[0:1], cap_blk, Q), 1)
    b, by = bound_ms(4 * Q + 8 * nb * cap_blk + 4 * nb + 4, 2 * Q)
    kernels["block_select"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b,
                                   bound_by=by, library_ms=None, max_abs_err=err,
                                   elements=Q, cap_blk=cap_blk)
    del S, row, th
    free(torch)

    # ---- 4. the main path ---------------------------------------------------
    counters = {"block_select": FK.block_select, "update_max": DK.update_max,
                "tail_hist": DK.tail_hist, "apply_mask": DK.apply_mask}
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
    for impl in ("pallas", "fused"):
        min_zeros = []

        def on_step(t, sim, metrics):
            min_zeros.append(min(int((sim.state[b] == 0).sum(dim=1).min())
                                 for b in ("u", "v")))

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

    # ---- 6. kernel summary --------------------------------------------------
    meta = {
        "block_select": ("src/repro_torch/csrc/fused_sync.cu",
                         "src/repro/kernels/fused_sync/kernel.py:67"),
        "update_max": ("src/repro_torch/csrc/dgc.cu",
                       "src/repro/kernels/dgc/kernel.py:47"),
        "tail_hist": ("src/repro_torch/csrc/dgc.cu",
                      "src/repro/kernels/dgc/kernel.py:88"),
        "apply_mask": ("src/repro_torch/csrc/dgc.cu",
                       "src/repro/kernels/dgc/kernel.py:119"),
    }
    rows = []
    for name, (source, replaces) in meta.items():
        k = kernels[name]
        per_path = {p: c[name] for p, c in by_path.items() if c[name]}
        if not per_path:
            raise AssertionError(f"{name} was launched on no path")
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": sum(per_path.values()),
                     "launches_by_path": per_path,
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
