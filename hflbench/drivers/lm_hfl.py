"""HFL training of a language model through the port's main path.

The window drives ``repro_torch.core.schedule.run_hfl`` over
``core.hfl.make_cluster_train_step(launch.steps.make_loss_fn(cfg), SGDM,
constant lr)`` and ``core.hfl.make_sync(SyncPlan(hfl))`` on the state of
``core.hfl.hfl_init``: whole rounds of H steps and a sync, until the window's
seconds have passed.  Set-up drives the same objects through the first
steps (at least three, and through the first sync) on the pool's first
batches and reads them; the reference then follows those steps from the
same weights and batches.
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from types import SimpleNamespace

import torch

from hflbench import check, gen
from hflbench.profiling import Profile, Spans, allocated, print_round_times
from hflbench.reference.lm import hfl_readings, named_leaves
from hflbench.reference.omega import RULE_OF_IMPL

MODEL_KEYS = ("num_layers", "d_model", "num_heads", "num_kv_heads", "d_ff", "vocab_size",
              "head_dim", "norm_type", "act", "tie_embeddings", "dtype", "remat",
              "rope_theta", "norm_eps")


def _norms_by_leaf(tree, rows, minus=None):
    """{leaf: [norm of row n]} of a stacked tree (``rows`` rows), or of one
    tree (``rows`` None); ``minus`` a tree of the same leaves subtracted."""
    out = {}
    base = dict(named_leaves(minus)) if minus is not None else {}
    for name, t in named_leaves(tree):
        ts = [t[n] for n in range(rows)] if rows else [t]
        out[name] = [float(torch.linalg.vector_norm(
            x.float() - (base[name].float() if name in base else 0.0))) for x in ts]
    return out


class Driver:
    def __init__(self, ctx, sync):
        self.ctx, self.sync = ctx, sync
        self.m, self.t = ctx.config["model"], ctx.traffic
        self.hfl = {**ctx.config["hfl"], "mus": self.t["mus"], "period": self.t["period"]}
        self.rule = RULE_OF_IMPL[self.t["omega_impl"]]
        H = self.hfl["period"]
        # the steps the reference follows: at least three, and the first sync
        self.followed = max(3, H)
        self.loss_steps = None  # every followed step's loss is compared
        self.warm_rounds = -(-self.followed // H)

    # -- the program ------------------------------------------------------
    def setup(self):
        from repro_torch.configs import get_config
        from repro_torch.configs.base import HFLConfig, TierConfig
        from repro_torch.core.hfl import SyncPlan, hfl_init, make_cluster_train_step, make_sync
        from repro_torch.launch.steps import make_loss_fn
        from repro_torch.optim import SGDM, constant_lr

        m, h, dev = self.m, self.hfl, self.ctx.device
        cfg = dataclasses.replace(get_config(m["name"]), **{k: m[k] for k in MODEL_KEYS})
        phi = h["phi"]
        self.hcfg = HFLConfig(tiers=(
            TierConfig(fanout=h["mus"], period=1, phi_up=phi[0], phi_down=phi[1]),
            TierConfig(fanout=h["clusters"], period=h["period"], phi_up=phi[2],
                       phi_down=phi[3], beta_up=h["beta_s"], beta_down=h["beta_m"])),
            momentum=h["momentum"], sync_mode="sparse", omega_impl=self.t["omega_impl"])
        opt = SGDM(momentum=h["momentum"])
        self.state = hfl_init(gen.lm_weights(m, self.ctx.seed, dev), opt, self.hcfg)
        loss_fn = make_loss_fn(cfg)
        train = make_cluster_train_step(loss_fn, opt, constant_lr(h["lr"]))
        self.train, self.sync_step = self._faulty(train, make_sync(SyncPlan(self.hcfg)))
        self.pool = gen.lm_pool(m, self.t, h["clusters"], self.ctx.seed, dev)
        self.batches = ({"tokens": self.pool[i % len(self.pool)]} for i in itertools.count())
        # the first steps, read as they go, then the rest of their round
        N = h["clusters"]
        prog = {"loss": [], "grad1": None, "change": None}
        done = itertools.count()  # run_hfl numbers the steps of each call from 0

        def on_step(_, state, losses):
            step = next(done)
            if step < self.followed:
                prog["loss"].append([float(v) for v in losses])
            if step == 0:
                prog["grad1"] = _norms_by_leaf(state.opt["m"], N)
            if step == self.followed - 1:
                w0 = gen.lm_weights(m, self.ctx.seed, dev)
                ch = _norms_by_leaf(state.params, N, minus=w0)
                ch.update({"w_ref/" + k: v for k, v in
                           _norms_by_leaf(state.w_ref, None, minus=w0).items()})
                prog["change"] = ch
                del w0

        self._rounds(self.warm_rounds, on_step)
        self.prog = prog

    def _faulty(self, train, sync_step):
        """The program's steps, with the fault a test plants (``ctx.fault``)."""
        fault, N = self.ctx.fault, self.hfl["clusters"]
        if fault == "unchanged":  # the state is returned as it came in
            return (lambda s, b: (s, train(s, b, keep=[False] * N)[1])), sync_step
        if fault == "half_batch":
            return (lambda s, b: train(s, {"tokens": b["tokens"][:, :b["tokens"].shape[1] // 2]}),
                    sync_step)
        if fault == "no_exchange":
            return train, (lambda s: s)
        if fault == "altered":  # the step's answer changed where it is made
            def altered(s, b):
                state, losses = train(s, b)
                return state, losses * 1.01
            return altered, sync_step
        if fault is not None:
            raise ValueError(f"unknown fault {fault!r}")
        return train, sync_step

    def _rounds(self, n, on_step=None, train=None, sync_step=None):
        from repro_torch.core.schedule import run_hfl

        H = self.hfl["period"]
        for _ in range(n):
            self.state = run_hfl(self.state, train or self.train, sync_step or self.sync_step,
                                 self.batches, H, H, on_step=on_step)

    def window(self, seconds, traced):
        H, N = self.hfl["period"], self.hfl["clusters"]
        per_step = N * self.t["mus"] * self.t["batch_per_mu"] * self.t["seq"]
        losses = []
        collect = lambda step, state, l: losses.append(l)
        spans = Spans(self.sync) if traced else None
        train = spans.wrap("train_step", self.train) if traced else None
        sync_step = spans.wrap("sync", self.sync_step) if traced else None
        trace = None
        if traced:  # the profiled rounds first; their spans are not read
            with Profile() as prof:
                self._rounds(self.t["trace_rounds"], collect, train, sync_step)
                self.sync()
            trace = prof.trace
            spans.seconds.clear()
        self.sync()
        t0 = time.perf_counter()
        rounds, marks, held = 0, [t0], []
        while not rounds or time.perf_counter() - t0 < seconds:
            self._rounds(1, collect, train, sync_step)
            self.sync()
            rounds += 1
            marks.append(time.perf_counter())
            held.append(allocated(self.ctx.device))
        print_round_times(marks, held)
        window_s = time.perf_counter() - t0
        failed = sum(1 for l in losses if not bool(torch.isfinite(l).all()))
        tokens = rounds * H * per_step
        info = {"tokens": tokens, "window_s": window_s, "rounds": rounds,
                "trace_rounds": self.t["trace_rounds"] if traced else 0,
                "rows": self.t["mus"] * self.t["batch_per_mu"], "seq": self.t["seq"]}
        rate = self.ctx.cell.get("rate_metric", "train_tokens_per_s")
        return SimpleNamespace(end_to_end={rate: tokens / window_s},
                               attempted=len(losses), failed=failed, trace=trace,
                               spans=spans, info=info)

    def release(self):
        self.first = [self.pool[s % len(self.pool)] for s in range(self.followed)]
        del self.state, self.train, self.sync_step, self.batches, self.pool

    # -- the reference ----------------------------------------------------
    def reference(self, lower=False):
        """The reference's readings of the steps followed, from the seed's
        weights and the batches the program took; ``lower``: the control,
        every product in float8."""
        w0 = gen.lm_weights(self.m, self.ctx.seed, self.ctx.device)
        return hfl_readings(w0, self.first, self.m, self.hfl, self.followed,
                            precision="fp8" if lower else "f32", rule=self.rule)

    def check(self, limits):
        return check.judge(check.gaps(self.prog, self.reference(), self.loss_steps), limits)
