"""End-to-end HFL training driver (the scenario-free path of
``repro.launch.train``), on the card unless ``--device cpu`` is given.

Trains an (optionally reduced) architecture with the hierarchical-FL
engine on synthetic LM data: N clusters x M MUs, intra-cluster aggregation
every step, sparse cross-cluster consensus every H steps, and a final
held-out eval of the consensus model. Same flags, LR scaling, data
streams and ``first-loss/last-loss/eval-loss`` trailer as the reference:

  PYTHONPATH=src python -m repro_torch.launch.train --full \
      --tiers 2x2:H=2 --sync sparse --omega-impl fused --steps 4

With ``--scenario`` the run goes through the HCN simulator
(``repro_torch.sim``): the same train and sync steps on the card, driven
on a virtual wall clock priced by the wireless model (bit-identical to the
reference's for the same ``--sim-seed``), with the reference's ``[sim]``
trailer and ``--trace-out`` JSON; ``--payload-accounting measured
--codec NAME`` prices the fronthaul with the real sync payloads' codec
streams:

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
      --scenario paper-fig3 --steps 4 --batch-per-mu 2 --seq 32

The port runs every depth-2 scenario: the lockstep and deadline ones,
the async ones (``async``, ``trace-replay``, ``flash-crowd``,
``scale-1m``, ``scale-100k``; each event trains one cluster through
``make_masked_cluster_train_step``) and ``manhattan``; ``--trace-in``
replays a mobility trace file (CSV/JSONL, the README's schema) and
``--residency move|duplicate|stale`` attaches the data-residency tracker:

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
      --scenario trace-replay --trace-in trace.csv --residency move \
      --steps 4 --batch-per-mu 2 --seq 32

The depth-3 scenarios (``hier-3tier``, ``hier-deadline``), observability
(``--obs-*``, ``--trace-viz``, ``--metrics-out``) and checkpoints are not
ported yet and raise, naming their ROADMAP item.
``--layers N`` keeps the first N layers of the architecture (full width
with ``--full``), so a configuration's state fits a card.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch

from repro_torch.configs import HFLConfig, get_config, parse_tiers_spec
from repro_torch.core.hfl import (
    SyncPlan, hfl_init, make_cluster_train_step,
    make_masked_cluster_train_step, make_sync, serving_params,
)
from repro_torch.core.schedule import run_hfl
from repro_torch.data import SyntheticLM
from repro_torch.device import resolve
from repro_torch.launch.steps import make_loss_fn
from repro_torch.models.transformer import forward, init_model
from repro_torch.optim import SGDM, warmup_step_decay

# flag -> ROADMAP item that ports it
_NOT_PORTED = {
    "trace_viz": "Queue 1 item 14 (observability)",
    "metrics_out": "Queue 1 item 14 (observability)",
    "obs_heartbeat": "Queue 1 item 14 (observability)",
    "obs_hlo_cost": "Queue 1 item 14 (observability)",
    "obs_health": "Queue 1 item 14 (observability)",
    "ckpt_dir": "Queue 1 item 17 (checkpoints)",
}


class StepClock:
    """First completed step = warm-up (allocator, kernel build, cuBLAS
    autotune); ``steady_s_per_step`` averages the steps after it."""

    def __init__(self):
        self.t0 = time.perf_counter()
        self._t_first = None
        self.steps = 0

    def step(self) -> None:
        self.steps += 1
        if self._t_first is None:
            self._t_first = time.perf_counter()

    def summary(self) -> dict:
        first = None if self._t_first is None else self._t_first - self.t0
        steady = None
        if self._t_first is not None and self.steps >= 2:
            steady = (time.perf_counter() - self._t_first) / (self.steps - 1)
        return {"steps": self.steps, "compile_s": first,
                "steady_s_per_step": steady}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--layers", type=int, default=None,
                    help="keep the first N layers (a depth cut; the width "
                         "stays the configuration's)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--tiers", default=None,
                    help="hierarchy spec FANOUTS[:H=PERIODS]: fan-outs "
                         "root-down (4x2 = 4 clusters x 2 MUs), periods "
                         "bottom-up (H=4)")
    ap.add_argument("--clusters", type=int, default=None,
                    help="alias of --tiers CxM:H=P")
    ap.add_argument("--mus", type=int, default=None,
                    help="alias of --tiers CxM:H=P")
    ap.add_argument("--period", type=int, default=None,
                    help="alias of --tiers CxM:H=P")
    ap.add_argument("--sync", default="sparse",
                    choices=["dense", "sparse", "quantized_sparse"])
    ap.add_argument("--omega-impl", default="topk",
                    choices=["topk", "hist", "pallas", "fused"],
                    help="Ω selection: fused = block_select kernel pipeline; "
                         "pallas = update_max/tail_hist kernel threshold")
    ap.add_argument("--sync-layout", default="flat", choices=["flat", "leaf"])
    ap.add_argument("--flat-shards", type=int, default=1)
    ap.add_argument("--payload-accounting", default="analytic",
                    choices=["analytic", "measured"])
    ap.add_argument("--codec", default="delta-varint")
    ap.add_argument("--wire-format", default="bf16", choices=["bf16", "q8"])
    ap.add_argument("--batch-per-mu", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=0.25)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--log-every", type=int, default=20)
    ap.add_argument("--scenario", default=None,
                    help="run through the HCN simulator: paper-fig3 | "
                         "stragglers | mobility | dropout | async | "
                         "trace-replay | manhattan | fault-dead-cluster | "
                         "diurnal | flash-crowd | scale-1m | prate-biased "
                         "(a scenario may pin HFL settings: paper-fig3 "
                         "pins 7 clusters x 4 MUs, H=2 and the paper's φ)")
    ap.add_argument("--sim-seed", type=int, default=0,
                    help="fleet/scenario seed (replay is bit-identical)")
    ap.add_argument("--trace-out", default=None,
                    help="write the wall-clock trace JSON here")
    ap.add_argument("--trace-in", default=None,
                    help="replay this mobility trace (CSV/JSONL: t,mu_id,x,y) "
                         "instead of the scenario's mobility model")
    ap.add_argument("--residency", default=None,
                    choices=["static", "move", "duplicate", "stale"],
                    help="data residency policy as MUs re-associate "
                         "(overrides the scenario's)")
    ap.add_argument("--trace-viz", default=None)
    ap.add_argument("--metrics-out", default=None)
    ap.add_argument("--obs-heartbeat", type=int, default=0)
    ap.add_argument("--obs-hlo-cost", action="store_true")
    ap.add_argument("--obs-health", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda (default; raises without a GPU) or cpu")
    return ap.parse_args(argv)


def _wait(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _jsonable(obj):
    """numpy scalars -> python floats/ints so traces dump cleanly."""
    if isinstance(obj, dict):
        return {k: _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, (np.floating, np.integer)):
        return obj.item()
    return obj


def run(args, *, on_sync=None, wrap_train_step=None,
        wrap_masked_step=None) -> dict:
    """Train as ``args`` says. ``on_sync(index, state, seconds)`` is called
    after each sync; under an async scenario it is called after each
    event's per-cluster sync with the engine's event dict as a fourth
    argument (cluster, round, staleness, weight and the sent uplink/
    downlink payloads, ``SimEngine.run``'s ``on_async_sync``).
    ``wrap_train_step(train_step)`` and ``wrap_masked_step(masked_step)``
    may wrap the all-cluster and the one-cluster train step
    (instrumentation hooks). Returns hist (mean loss per step; the active
    cluster's per async event), eval_loss, timing, the per-sync seconds
    and the simulator's trace and engine (None without ``--scenario``)."""
    for flag, item in _NOT_PORTED.items():
        if getattr(args, flag):
            raise SystemExit(f"--{flag.replace('_', '-')} is not ported yet "
                             f"(ROADMAP {item})")
    scenario = None
    if args.scenario is not None:
        from repro_torch.sim.scenarios import apply_hfl_overrides, get_scenario

        scenario = get_scenario(args.scenario)
    dev = resolve(args.device)
    if dev.type == "cuda":  # model math in bf16/f32; never TF32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    given = {f: v for f, v in (("--clusters", args.clusters),
                               ("--mus", args.mus), ("--period", args.period))
             if v is not None}
    if args.tiers is not None:
        if given:
            raise SystemExit(f"--tiers conflicts with {'/'.join(sorted(given))}")
        tiers = parse_tiers_spec(args.tiers)
    else:
        tiers = parse_tiers_spec(
            f"{args.clusters or 4}x{args.mus or 2}:H={args.period or 4}")
    hfl = HFLConfig(tiers=tiers, sync_mode=args.sync,
                    omega_impl=args.omega_impl, sync_layout=args.sync_layout,
                    flat_shards=args.flat_shards, wire_format=args.wire_format,
                    payload_accounting=args.payload_accounting,
                    codec=args.codec)
    engine = None
    if scenario is not None:
        from repro_torch.sim.scenarios import build_engine

        hfl = apply_hfl_overrides(scenario, hfl)
        engine = build_engine(scenario, hfl, seed=args.sim_seed,
                              trace_file=args.trace_in,
                              residency=args.residency)
    N = hfl.num_clusters
    print(f"[train] arch={cfg.name} clusters={N} "
          f"mus/cluster={hfl.mus_per_cluster} H={hfl.tiers[1].period} "
          f"sync={hfl.sync_mode} layout={hfl.sync_layout} "
          f"omega={hfl.omega_impl} device={dev}"
          + (f" scenario={scenario.name}" if scenario is not None else ""),
          flush=True)

    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_model(gen, cfg, device=dev)
    opt = SGDM(momentum=0.9, weight_decay=1e-4)
    sched = warmup_step_decay(args.lr * hfl.total_mus * args.batch_per_mu / 128,
                              warmup_steps=max(args.steps // 20, 1),
                              decay_steps=(args.steps // 2, 3 * args.steps // 4))
    state = hfl_init(params, opt, hfl)
    del params
    loss_fn = make_loss_fn(cfg)
    train_step = make_cluster_train_step(loss_fn, opt, sched)
    if wrap_train_step is not None:
        train_step = wrap_train_step(train_step)
    # async rounds advance ONE cluster: the masked step trains only it
    masked_step = make_masked_cluster_train_step(loss_fn, opt, sched)
    if wrap_masked_step is not None:
        masked_step = wrap_masked_step(masked_step)
    sync_step = make_sync(SyncPlan(hfl))

    sync_s = []

    def timed_sync(st):
        _wait(dev)
        t0 = time.perf_counter()
        st = sync_step(st)
        _wait(dev)
        sync_s.append(time.perf_counter() - t0)
        if on_sync is not None:
            on_sync(len(sync_s), st, sync_s[-1])
        return st

    lm = SyntheticLM(cfg.vocab_size, seed=1)
    rng = np.random.default_rng(2)
    local_b = hfl.mus_per_cluster * args.batch_per_mu

    def make_batches():
        while True:
            toks = lm.sample(N * local_b, args.seq, rng)
            yield {"tokens": torch.from_numpy(toks).to(dev, torch.int64)
                   .reshape(N, local_b, args.seq)}

    hist = []
    clock = StepClock()

    def on_step(t, s, loss):
        l = float(loss.mean())  # waits for the step to finish
        clock.step()
        hist.append(l)
        if (t + 1) % args.log_every == 0:
            ss = clock.summary()["steady_s_per_step"]
            rate = ss if ss is not None else (time.perf_counter() - clock.t0) / clock.steps
            print(f"  step {t+1:5d}  loss {l:.4f}  ({rate:.2f}s/step)", flush=True)

    def async_synced(event, st):
        sync_s.append(event["seconds"])
        if on_sync is not None:
            on_sync(len(sync_s), st, sync_s[-1], event)

    trace = None
    if engine is not None:
        state, trace = engine.run(state, train_step, timed_sync, make_batches(),
                                  args.steps, on_step=on_step,
                                  masked_train_step=masked_step,
                                  on_async_sync=async_synced)
        _sim_trailer(scenario, trace, args.trace_out)
    else:
        state = run_hfl(state, train_step, timed_sync, make_batches(),
                        hfl.tiers[1].period, args.steps, on_step)

    timing = clock.summary()
    if timing["steps"]:
        cs, ss = timing["compile_s"], timing["steady_s_per_step"]
        print(f"[train] compile_s={cs:.2f}"
              + (f"  steady={ss:.3f}s/step" if ss is not None
                 else "  (one step; no steady-state sample)")
              + "  sync_ms=" + ",".join(f"{1e3 * s:.1f}" for s in sync_s),
              flush=True)

    with torch.no_grad():
        sp = serving_params(state)
        toks = torch.from_numpy(lm.sample(32, args.seq, np.random.default_rng(99))
                                ).to(dev, torch.int64)
        logits, _ = forward(sp, toks, cfg)
        lp = torch.log_softmax(logits[:, -args.seq:].float(), dim=-1)
        eval_loss = float(-torch.gather(lp[:, :-1], -1, toks[:, 1:, None]).mean())
    if hist:
        print(f"[train] first-loss={hist[0]:.4f} last-loss={hist[-1]:.4f} "
              f"eval-loss={eval_loss:.4f}", flush=True)
    else:
        print(f"[train] no training rounds completed; eval-loss={eval_loss:.4f}",
              flush=True)
    return {"hist": hist, "eval_loss": eval_loss, "timing": timing,
            "sync_s": sync_s, "trace": trace, "engine": engine}


def _sim_trailer(scenario, trace, trace_out) -> None:
    """The reference's ``[sim]`` lines, and the trace JSON if asked."""
    m = trace.meta
    print(f"[sim] scenario={scenario.name} discipline={m['discipline']} "
          f"residency={m['residency']} "
          f"virtual-wallclock={trace.wallclock:.3f}s "
          f"syncs={m['sync_launches']} "
          f"fronthaul={m['bits_fronthaul_total']/8e6:.2f}MB", flush=True)
    if m.get("payload_accounting") == "measured":
        bpp = m.get("bits_per_param_mean")
        print(f"[sim] measured payloads: codec={m['codec']} "
              f"Q={m['payload_size']} "
              f"sbs_ul={m['bits_sbs_ul']/8e6:.3f}MB "
              f"mbs_dl={m['bits_mbs_dl']/8e6:.3f}MB "
              + (f"bits/param={bpp:.3f}" if bpp is not None else ""),
              flush=True)
    print(f"[sim] t_fl_iter={m['t_fl_iter_s']:.3f}s "
          f"t_hfl_iter={m['t_hfl_iter_s']:.3f}s "
          f"t_hfl_period={m['t_hfl_period_s']:.3f}s "
          f"(period<fl_iter: {m['t_hfl_period_s'] < m['t_fl_iter_s']})",
          flush=True)
    if trace_out:
        with open(trace_out, "w") as f:
            json.dump(_jsonable(trace.to_json()), f, indent=1)
        print(f"[sim] trace -> {trace_out}", flush=True)


def main(argv=None):
    out = run(parse_args(argv))
    return out["hist"], out["eval_loss"]


if __name__ == "__main__":
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    main()
