"""The paper's own engine: ``repro_torch.core.federated.FaithfulHFL.step``.

The loss is the port's (``launch.paper_accuracy.make_fns``: ResNet-18 from
``models.resnet`` on the flat vector, BatchNorm on batch statistics); the
selections run through the cell's ``omega_impl``.  The window runs whole
rounds of H iterations until its seconds have passed.  Set-up drives the
same engine through its first round (H iterations, the last one a sync) on
the pool's first batches and reads it; the reference follows that round.
"""
from __future__ import annotations

import itertools
import math
import time
from types import SimpleNamespace

import torch

from hflbench import check, gen
from hflbench.profiling import Profile, Spans, allocated, print_round_times
from hflbench.reference.faithful import faithful_readings
from hflbench.reference.lm import named_leaves
from hflbench.reference.omega import RULE_OF_IMPL


def _by_leaf(rows, sizes, names):
    """{leaf: [norm of that leaf's part of each row]} of flat rows [R, Q]."""
    out = {}
    for r in rows:
        for name, part in zip(names, r.split(sizes)):
            out.setdefault(name, []).append(float(torch.linalg.vector_norm(part)))
    return out


class Driver:
    def __init__(self, ctx, sync):
        self.ctx, self.sync = ctx, sync
        self.m, self.t, self.hfl = ctx.config["model"], ctx.traffic, ctx.config["hfl"]
        self.K = self.hfl["clusters"] * self.hfl["mus"]
        self.rule = RULE_OF_IMPL[self.t["omega_impl"]]
        # the first iteration's loss alone: a later one follows Ω's selections,
        # where f32 rounding can move the threshold across a whole histogram
        # bin of a large leaf and shift that loss by 1e-4 on a sound run
        self.loss_steps = 1

    def _weights(self):
        return gen.resnet_weights(self.m, self.ctx.seed, self.ctx.device)

    def setup(self):
        from repro_torch.configs.base import HFLConfig, TierConfig
        from repro_torch.core.federated import FaithfulHFL
        from repro_torch.launch.paper_accuracy import make_fns

        h, dev = self.hfl, self.ctx.device
        w0tree = self._weights()
        bn = {k: {"mean": torch.zeros_like(v["scale"]), "var": torch.ones_like(v["scale"])}
              for k, v in w0tree.items() if isinstance(v, dict)}
        w0, loss_fn, _ = make_fns(w0tree, bn)
        self.names, leaves = zip(*named_leaves(w0tree))
        self.sizes = [t.numel() for t in leaves]
        phi = h["phi"]
        hcfg = HFLConfig(tiers=(
            TierConfig(fanout=h["mus"], period=1, phi_up=phi[0], phi_down=phi[1]),
            TierConfig(fanout=h["clusters"], period=h["period"], phi_up=phi[2],
                       phi_down=phi[3], beta_up=h["beta_s"], beta_down=h["beta_m"])),
            momentum=h["momentum"])
        lr = h["lr"]
        self.sim = FaithfulHFL(w0=w0, hfl_cfg=hcfg, lr_schedule=lambda t: lr,
                               loss_fn=loss_fn, sparsify_impl=self.t["omega_impl"])
        self.x, self.y = gen.image_pool(self.m, self.t, self.K, self.ctx.seed, dev)
        self.it = itertools.count()
        self.step = self._faulty(self.sim.step)
        # the first round, read as it goes
        H = h["period"]
        prog = {"loss": []}
        lr32 = float(torch.tensor(h["lr"], dtype=torch.float32))
        for t in range(H):
            prog["loss"].append([self._iterate(self.step)["loss"]])
            if t == 0:
                # each cluster's mean gradient as the state holds it after one
                # step: the momentum left with its MUs (the sent part cleared)
                # plus the sparse mean the SBS stepped by, -(e_n + w_n - w0)/lr
                st, M = self.sim.state, h["mus"]
                prog["grad1"] = {}
                for n in range(h["clusters"]):  # one [Q] row at a time: no peak of its own
                    g = st["u"][n * M:(n + 1) * M].mean(dim=0)
                    g -= (st["e_n"][n] + st["w_tilde_n"][n] - w0) / lr32
                    for name, v in _by_leaf(g[None], self.sizes, self.names).items():
                        prog["grad1"].setdefault(name, []).extend(v)
                    del g
        st = self.sim.state
        prog["change"] = {}
        for row in st["w_tilde_n"]:
            for name, v in _by_leaf((row - w0)[None], self.sizes, self.names).items():
                prog["change"].setdefault(name, []).extend(v)
        prog["change"].update({"w_ref/" + k: v for k, v in
                               _by_leaf((st["w_ref"] - w0)[None], self.sizes, self.names).items()})
        self.prog = prog

    def _batch(self, i):
        j = i % self.x.shape[0]
        return self.x[j], self.y[j]

    def _iterate(self, step):
        with torch.backends.mkldnn.flags(enabled=self.ctx.device.type != "cpu"):
            return step(self._batch(next(self.it)))

    def _faulty(self, step):
        fault, sim = self.ctx.fault, self.sim
        if fault == "unchanged":  # the state is left as it was
            def unchanged(b):
                saved = {k: (v.clone() if torch.is_tensor(v) else v) for k, v in sim.state.items()}
                out = step(b)
                sim.state.update(saved)
                return out
            return unchanged
        if fault == "half_batch":
            return lambda b: step((b[0][:, :b[0].shape[1] // 2], b[1][:, :b[1].shape[1] // 2]))
        if fault == "no_exchange":  # the consensus never fires
            def no_exchange(b):
                t = sim.state["t"]
                sim.state["t"] = 0  # (0 + 1) % H != 0: no sync is due
                out = step(b)
                sim.state["t"] = t + 1
                return out
            return no_exchange
        if fault == "altered":
            def altered(b):
                out = step(b)
                return {**out, "loss": out["loss"] * 1.01}
            return altered
        if fault is not None:
            raise ValueError(f"unknown fault {fault!r}")
        return step

    def window(self, seconds, traced):
        H = self.hfl["period"]
        spans = Spans(self.sync) if traced else None
        trace, done, failed = None, 0, 0

        def one(step):
            nonlocal done, failed
            name = "iteration.sync" if (self.sim.state["t"] + 1) % H == 0 else "iteration.plain"
            call = spans.wrap(name, step) if traced else step
            failed += not math.isfinite(self._iterate(call)["loss"])
            done += 1

        if traced:  # the profiled round first; its spans are not read
            with Profile() as prof:
                for _ in range(H * self.t["trace_rounds"]):
                    one(self.step)
                self.sync()
            trace = prof.trace
            spans.seconds.clear()
        profiled, done = done, 0
        self.sync()
        t0 = time.perf_counter()
        marks, held = [t0], []
        while not done or time.perf_counter() - t0 < seconds:
            for _ in range(H):
                one(self.step)
            self.sync()
            marks.append(time.perf_counter())
            held.append(allocated(self.ctx.device))
        print_round_times(marks, held)
        window_s = time.perf_counter() - t0
        images = done * self.K * self.t["batch_per_mu"]
        info = {"images": images, "iterations": done, "window_s": window_s,
                "trace_iterations": H * self.t["trace_rounds"], "mus": self.K,
                "batch_per_mu": self.t["batch_per_mu"], "sizes": self.sizes}
        return SimpleNamespace(end_to_end={"train_images_per_s": images / window_s},
                               attempted=profiled + done, failed=failed, trace=trace,
                               spans=spans, info=info)

    def release(self):
        H = self.hfl["period"]
        self.first = [self._batch(t) for t in range(H)]
        del self.sim, self.step

    def reference(self, lower=False):
        """The reference's readings of the first round, from the seed's
        weights and the batches the program took; ``lower``: the control,
        its products in TF32."""
        with torch.backends.mkldnn.flags(enabled=self.ctx.device.type != "cpu"):
            return faithful_readings(self._weights(), self.first, self.hfl, self.hfl["period"],
                                     rule=self.rule, tf32=lower)

    def check(self, limits):
        return check.judge(check.gaps(self.prog, self.reference(), self.loss_steps), limits)
