"""End-to-end HFL training driver (the scenario-free path of
``repro.launch.train``), on the card unless ``--device cpu`` is given.

Trains an (optionally reduced) architecture, any of the ten ``--arch``
(a frontend architecture's batches carry its stub embeddings, one seed
drawn from the token stream's rng per batch as the reference draws its
key), with the hierarchical-FL engine on synthetic LM data: N clusters x
M MUs, intra-cluster aggregation every step, sparse cross-cluster
consensus every H steps, and a final held-out eval of the consensus
model. Same flags, LR scaling, data streams and
``first-loss/last-loss/eval-loss`` trailer as the reference:

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

The port runs every scenario: the lockstep and deadline ones, the async
ones (``async``, ``trace-replay``, ``flash-crowd``, ``scale-1m``,
``scale-100k``; each event trains one cluster through
``make_masked_cluster_train_step``), ``manhattan`` and the depth-3 trees
(``hier-3tier``, ``hier-deadline``: the tiered cascade of
``core.hfl.HierSyncStep``); ``--trace-in`` replays a mobility trace file
(CSV/JSONL, the README's schema) and ``--residency move|duplicate|stale``
attaches the data-residency tracker:

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
      --scenario trace-replay --trace-in trace.csv --residency move \
      --steps 4 --batch-per-mu 2 --seq 32

Without a scenario, ``--tiers`` of any depth runs the plain loop
(``core.schedule.run_hfl``); ``:async`` makes the root tier clock-free,
which runs the simulator's unit scheduler without a radio:

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
      --tiers 2x2x4:H=2,2:async --steps 4 --batch-per-mu 2 --seq 32

Observability (``repro_torch.obs``), the reference's flags and events:
``--trace-viz out.json`` exports a Chrome/Perfetto trace of every
simulator event on the virtual clock plus host-clock spans of the step
calls (scenario runs); ``--metrics-out run.jsonl`` streams every console
line as a structured JSONL event and appends the final metrics-registry
snapshot, which ``tools/run_compare.py`` gates against a golden;
``--obs-health`` turns on the learning-health monitor (per-cluster drift,
residual and Ω-overlap statistics from the sync, staleness and
participation fairness from the simulator, streaming anomaly rules);
``--obs-heartbeat N`` prints events/s and the card's live bytes every N
simulator events; ``--obs-hlo-cost`` counts the flops, bytes and launches
of the first train step and the first sync step as they run
(``launch.op_cost``). A run computes the same with telemetry on or off:

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
      --scenario paper-fig3 --steps 4 --tiers 3x2:H=2 --batch-per-mu 1 \
      --seq 16 --obs-health --trace-viz trace.json --metrics-out run.jsonl

``--flat-shards S`` with ``--omega-impl fused`` runs the sharded flat
sync: the padded flat vector as S contiguous pieces, one candidate
compaction per piece and a merge (the single-process form of the mesh
path, ``core.hfl.make_sync`` on a ``launch.mesh`` mesh). ``--ckpt-dir D``
saves the final state after eval as ``D/ckpt_{steps:08d}.msgpack``, the
reference's file byte for byte (``repro_torch.checkpoint``; restoring is
that module's API). ``--layers N`` keeps the first N layers of the
architecture (full width with ``--full``), so a configuration's state fits
a card.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch

from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs import HFLConfig, get_config, parse_tiers_spec
from repro_torch.configs.base import warn_legacy_cli_flag
from repro_torch.core.hfl import (
    SyncPlan, hfl_init, make_cluster_train_step,
    make_masked_cluster_train_step, make_sync, serving_params,
)
from repro_torch.core.schedule import run_hfl
from repro_torch.data import SyntheticLM
from repro_torch.device import resolve
from repro_torch.launch.op_cost import FirstCallCosts
from repro_torch.launch.steps import make_loss_fn
from repro_torch.models.frontends import fake_frontend_embeds
from repro_torch.models.transformer import forward, init_model
from repro_torch.obs import (
    ObsConfig, RunLogger, StepClock, current_registry, make_telemetry, use_registry,
)
from repro_torch.obs.spans import current_tracer, use_tracer
from repro_torch.optim import SGDM, warmup_step_decay

EVAL_CHUNK_TOKENS = 8192  # the held-out eval's rows per forward: this many tokens


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
                    help="hierarchy spec FANOUTS[:H=PERIODS][:async]: "
                         "fan-outs root-down (4x2 = 4 clusters x 2 MUs; "
                         "2x2x4 = 2 edges x 2 SBSs x 4 MUs), periods "
                         "bottom-up (H=2,2: tier 1 every 2 iterations, the "
                         "root every 2 tier-1 rounds); ':async' makes the "
                         "root tier clock-free")
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
                         "| hier-3tier | hier-deadline "
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
    ap.add_argument("--trace-viz", default=None,
                    help="export a Chrome/Perfetto trace-event JSON of the "
                         "run (virtual-clock simulator spans + host-clock "
                         "step calls). Scenario runs only.")
    ap.add_argument("--metrics-out", default=None,
                    help="stream structured run events as JSONL here "
                         "(config, per-step losses, timing, sim summary, "
                         "final metrics-registry snapshot)")
    ap.add_argument("--obs-heartbeat", type=int, default=0,
                    help="print an events/s + live-memory heartbeat to "
                         "stderr every N simulator events (0 = off)")
    ap.add_argument("--obs-hlo-cost", action="store_true",
                    help="count the flops, bytes and launches of the first "
                         "train step and the first sync step as they run")
    ap.add_argument("--obs-health", action="store_true",
                    help="learning-health monitor: per-cluster drift, "
                         "residual norms and Ω overlap from the sync, "
                         "staleness and participation fairness from the "
                         "simulator, streaming anomaly rules; the run "
                         "itself stays bit-identical")
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
    downlink payloads, ``SimEngine.run``'s ``on_async_sync``). At depth > 2
    the fourth argument is ``{"kind": "cascade", "top": top}`` after each
    tiered consensus, and the unit scheduler's event dict (``kind``
    "unit_sync" or "push") after each unit sync and push.
    ``wrap_train_step(train_step)`` and ``wrap_masked_step(masked_step)``
    may wrap the all-cluster and the one-cluster train step
    (instrumentation hooks). Returns hist (mean loss per step; the active
    cluster's per async event), eval_loss, timing, the per-sync seconds
    and the simulator's trace and engine (None without ``--scenario``),
    and ``telemetry``, the run's telemetry handle, whose registry and
    tracer are the ambient ones (``obs.current_registry``,
    ``obs.current_tracer``) only while the run lasts: a later run or test
    in the process does not emit into them."""
    with use_registry(current_registry()), use_tracer(current_tracer()):
        return _run(args, on_sync, wrap_train_step, wrap_masked_step)


def _run(args, on_sync, wrap_train_step, wrap_masked_step) -> dict:
    obs_cfg = None
    if (args.trace_viz or args.metrics_out or args.obs_heartbeat
            or args.obs_hlo_cost or args.obs_health):
        obs_cfg = ObsConfig(
            trace_path=args.trace_viz, metrics_path=args.metrics_out,
            heartbeat_events=args.obs_heartbeat,
            hlo_cost=bool(args.obs_hlo_cost), health=bool(args.obs_health))
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
        for f in sorted(given):
            warn_legacy_cli_flag(
                f, "--tiers CLUSTERSxMUS:H=PERIOD "
                   "(fan-outs root-down, periods bottom-up)")
        clusters = args.clusters if args.clusters is not None else 4
        mus = args.mus if args.mus is not None else 2
        period = args.period if args.period is not None else 4
        tiers = parse_tiers_spec(f"{clusters}x{mus}:H={period}")
    hfl = HFLConfig(tiers=tiers, sync_mode=args.sync,
                    omega_impl=args.omega_impl, sync_layout=args.sync_layout,
                    flat_shards=args.flat_shards, wire_format=args.wire_format,
                    payload_accounting=args.payload_accounting,
                    codec=args.codec)
    if scenario is not None:
        hfl = apply_hfl_overrides(scenario, hfl)
    N = hfl.num_clusters
    log = RunLogger(args.metrics_out)
    log.log(
        "config",
        f"[train] arch={cfg.name} clusters={N} "
        f"mus/cluster={hfl.mus_per_cluster} H={hfl.tiers[1].period} "
        f"sync={hfl.sync_mode} layout={hfl.sync_layout} "
        f"omega={hfl.omega_impl} device={dev}"
        + (f" scenario={scenario.name}" if scenario is not None else ""),
        arch=cfg.name, clusters=N, mus_per_cluster=hfl.mus_per_cluster,
        period=hfl.tiers[1].period, sync=hfl.sync_mode,
        layout=hfl.sync_layout, omega=hfl.omega_impl,
        payload_accounting=hfl.payload_accounting,
        scenario=(scenario.name if scenario is not None else None),
        steps=args.steps, seq=args.seq, batch_per_mu=args.batch_per_mu,
        device=str(dev))
    # the telemetry handle exists BEFORE the step builders run, so their
    # build-time counters land in this run's registry (the engine adopts
    # it; a run without a scenario holds it directly)
    engine = None
    if scenario is not None:
        from repro_torch.sim.scenarios import build_engine

        engine = build_engine(scenario, hfl, seed=args.sim_seed,
                              trace_file=args.trace_in,
                              residency=args.residency, obs=obs_cfg)
        tele = engine.obs
    else:
        tele = make_telemetry(obs_cfg)
    if tele.health.enabled:
        # anomalies stream to the JSONL runlog as structured health events
        tele.health.runlog = log

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
    # with --obs-health on a scenario run the sync also returns its health
    # statistics: a depth-2 local-flat feature (deeper hierarchies run the
    # tiered cascade, which rejects collect_stats)
    collect = bool(args.obs_health and scenario is not None
                   and args.sync_layout == "flat" and args.flat_shards == 1
                   and hfl.depth == 2)
    sync_step = make_sync(SyncPlan(hfl, collect_stats=collect))
    if obs_cfg is not None and obs_cfg.hlo_cost:
        # the port's steps update the state in place: count each step's
        # FIRST real call instead of an extra one that would perturb the run
        def report(fn):
            def logged(c):
                log.log("hlo_cost",
                        f"[obs] {fn}: {c['flops']/1e9:.3f} GFLOP "
                        f"{c['hbm_bytes']/1e6:.1f} MB HBM "
                        f"{c.get('launches', 0)} launches", fn=fn, **c)
            return logged

        train_step = FirstCallCosts(train_step, report("train_step"))
        sync_step = FirstCallCosts(sync_step, report("sync_step"))
    if wrap_train_step is not None:
        train_step = wrap_train_step(train_step)
    masked_step = None
    if engine is not None:
        # async rounds advance ONE cluster: the masked step trains only it
        masked_step = make_masked_cluster_train_step(loss_fn, opt, sched)
        if wrap_masked_step is not None:
            masked_step = wrap_masked_step(masked_step)

    sync_s = []

    def timed(fn, *args):
        _wait(dev)
        t0 = time.perf_counter()
        out = fn(*args)
        _wait(dev)
        sync_s.append(time.perf_counter() - t0)
        return out

    if getattr(sync_step, "hier", False):
        timed_sync = _TimedHier(sync_step, timed, sync_s, on_sync)
    else:
        def timed_sync(st):
            out = timed(sync_step, st)  # (state, stats) with collect_stats
            if on_sync is not None:
                on_sync(len(sync_s), out[0] if collect else out, sync_s[-1])
            return out

        timed_sync.collect_stats = collect

    lm = SyntheticLM(cfg.vocab_size, seed=1)
    rng = np.random.default_rng(2)
    local_b = hfl.mus_per_cluster * args.batch_per_mu

    F = cfg.frontend_tokens if cfg.frontend != "none" else 0

    def frontend(seed, batch):
        # drawn on the CPU, so the card and the CPU see the same embeddings
        gen = torch.Generator().manual_seed(seed)
        return fake_frontend_embeds(gen, cfg, batch).to(dev)

    def make_batches():
        while True:
            toks = lm.sample(N * local_b, args.seq, rng)
            b = {"tokens": torch.from_numpy(toks).to(dev, torch.int64)
                 .reshape(N, local_b, args.seq)}
            if F:  # one draw of the token stream's rng per batch, as the
                # reference seeds its frontend key
                fe = frontend(int(rng.integers(1 << 30)), N * local_b)
                b["frontend"] = fe.reshape(N, local_b, *fe.shape[1:])
            yield b

    hist = []
    clock = StepClock()

    def on_step(t, s, loss):
        l = float(loss.mean())  # waits for the step to finish
        clock.step()
        hist.append(l)
        if (t + 1) % args.log_every == 0:
            ss = clock.steady_s_per_step
            rate = ss if ss is not None else (time.perf_counter() - clock.t0) / clock.steps
            log.log("step", f"  step {t+1:5d}  loss {l:.4f}  ({rate:.2f}s/step)",
                    step=t + 1, loss=l, s_per_step=rate, steady=ss is not None)

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
        _sim_trailer(log, scenario, trace, args.trace_out)
        if args.trace_viz and tele.enabled:
            tele.export_chrome(args.trace_viz,
                               metadata={"engine_meta": _jsonable(trace.meta)})
            log.log("trace_viz", f"[obs] chrome trace -> {args.trace_viz}",
                    path=args.trace_viz, events=len(tele.tracer.events),
                    dropped=tele.tracer.dropped)
    else:
        state = run_hfl(state, train_step, timed_sync, make_batches(),
                        hfl.tiers[1].period, args.steps, on_step,
                        on_async_sync=async_synced)

    timing = clock.summary()
    if timing["steps"]:
        cs, ss = timing["compile_s"], timing["steady_s_per_step"]
        log.log("timing",
                f"[train] compile_s={cs:.2f}"
                + (f"  steady={ss:.3f}s/step" if ss is not None
                   else "  (one step; no steady-state sample)")
                + "  sync_ms=" + ",".join(f"{1e3 * s:.1f}" for s in sync_s),
                **timing)

    with torch.no_grad():
        sp = serving_params(state)
        toks = torch.from_numpy(lm.sample(32, args.seq, np.random.default_rng(99))
                                ).to(dev, torch.int64)
        fe = frontend(7, 32) if F else None
        # the 32 rows in chunks of at most EVAL_CHUNK_TOKENS tokens, so the
        # f32 log-probs of a long sequence need not all be live at once
        # (one chunk at the usual lengths: the same ops as one pass)
        rows = max(1, EVAL_CHUNK_TOKENS // args.seq)
        nll = []
        for r in range(0, 32, rows):
            logits, _ = forward(sp, toks[r:r + rows], cfg,
                                frontend_embeds=None if fe is None else fe[r:r + rows])
            lp = torch.log_softmax(logits[:, -args.seq:].float(), dim=-1)
            del logits
            nll.append(-torch.gather(lp[:, :-1], -1, toks[r:r + rows, 1:, None]))
            del lp
        eval_loss = float(torch.cat(nll).mean())
    if hist:
        log.log("eval",
                f"[train] first-loss={hist[0]:.4f} last-loss={hist[-1]:.4f} "
                f"eval-loss={eval_loss:.4f}",
                first_loss=hist[0], last_loss=hist[-1], eval_loss=eval_loss)
    else:
        log.log("eval", f"[train] no training rounds completed; "
                f"eval-loss={eval_loss:.4f}", eval_loss=eval_loss)
    if args.ckpt_dir:
        path = save_checkpoint(args.ckpt_dir, args.steps, state._asdict())
        log.log("checkpoint", f"[train] checkpoint -> {path}", path=str(path))
    if tele.health.enabled:
        hs = tele.health.summary()
        log.log("health_summary",
                f"[health] anomalies={hs['anomalies']} "
                f"by_rule={hs['by_rule'] or '{}'} "
                f"signals={len(hs['signals'])}", **hs)
    if tele.enabled:
        snap = tele.registry.snapshot()
        # histogram quantiles on the console (the full snapshot is
        # JSONL-only below — it is large and structured)
        for name, m in sorted(snap.items()):
            if m.get("kind") != "histogram":
                continue
            for lbl, h in m["series"].items():
                where = f"{{{lbl}}}" if lbl else ""
                print(f"[obs] {name}{where}: n={h['count']} "
                      f"p50={h['p50']:.4g} p95={h['p95']:.4g} "
                      f"p99={h['p99']:.4g} max={h['max']:.4g}", flush=True)
        log.log("metrics", None, metrics=snap)
    log.close()
    return {"hist": hist, "eval_loss": eval_loss, "timing": timing,
            "sync_s": sync_s, "trace": trace, "engine": engine,
            "telemetry": tele}


class _TimedHier:
    """The tiered sync (``core.hfl.HierSyncStep``) with each cascade timed
    and reported, ``on_sync(index, state, seconds, {"kind": "cascade",
    "top": top})``. It carries what the simulator and ``run_hfl`` read off
    a tiered sync (``hier``, ``cfg``, ``init_bufs``, ``fire_top``,
    ``unit_ops``); the unit scheduler times and reports its unit syncs and
    pushes itself."""

    hier = True
    collect_stats = False

    def __init__(self, inner, timed, sync_s, on_sync):
        self.cfg, self.init_bufs = inner.cfg, inner.init_bufs
        self.fire_top, self.unit_ops = inner.fire_top, inner.unit_ops
        self._inner, self._timed = inner, timed
        self._sync_s, self._on_sync = sync_s, on_sync

    def __call__(self, state, bufs, top=None):
        state, bufs = self._timed(self._inner, state, bufs, top)
        if self._on_sync is not None:
            self._on_sync(len(self._sync_s), state, self._sync_s[-1],
                          {"kind": "cascade", "top": top})
        return state, bufs


def _sim_trailer(log, scenario, trace, trace_out) -> None:
    """The reference's ``[sim]`` events, and the trace JSON if asked."""
    m = trace.meta
    log.log("sim_summary",
            f"[sim] scenario={scenario.name} discipline={m['discipline']} "
            f"residency={m['residency']} "
            f"virtual-wallclock={trace.wallclock:.3f}s "
            f"syncs={m['sync_launches']} "
            f"fronthaul={m['bits_fronthaul_total']/8e6:.2f}MB",
            **_jsonable(m))
    if m.get("payload_accounting") == "measured":
        bpp = m.get("bits_per_param_mean")
        log.log("sim_measured",
                f"[sim] measured payloads: codec={m['codec']} "
                f"Q={m['payload_size']} "
                f"sbs_ul={m['bits_sbs_ul']/8e6:.3f}MB "
                f"mbs_dl={m['bits_mbs_dl']/8e6:.3f}MB "
                + (f"bits/param={bpp:.3f}" if bpp is not None else ""))
    if m.get("wireless"):
        log.log("sim_latency",
                f"[sim] t_fl_iter={m['t_fl_iter_s']:.3f}s "
                f"t_hfl_iter={m['t_hfl_iter_s']:.3f}s "
                f"t_hfl_period={m['t_hfl_period_s']:.3f}s "
                f"(period<fl_iter: {m['t_hfl_period_s'] < m['t_fl_iter_s']})")
    if trace_out:
        with open(trace_out, "w") as f:
            json.dump(_jsonable(trace.to_json()), f, indent=1)
        log.log("trace_out", f"[sim] trace -> {trace_out}", path=trace_out)


def main(argv=None):
    out = run(parse_args(argv))
    return out["hist"], out["eval_loss"]


if __name__ == "__main__":
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    main()
