"""HFL training of DeepSeek-V2-Lite through the port's main path.

``lm_hfl``'s driver (``core.schedule.run_hfl`` over the cluster train step
and the flat sparse sync, the faults planted as there) on the MoE model:
MLA without a query LoRA, YaRN, the leading dense block, and the dropless
expert layer holding ``experts_held`` of the ``num_experts`` experts from
``experts_offset`` on.  Weights for that tree are drawn from ``--seed``;
the reference is ``reference.deepseek_v2_lite``.  The window tallies each
held expert's slots on the device (``models.moe.tally_load``) and prints
the load's spread on stderr after it: the largest and the smallest held
expert over their mean.
"""
from __future__ import annotations

import dataclasses
import itertools
import sys

import torch

from hflbench import gen
from hflbench.drivers import lm_hfl
from hflbench.reference.deepseek_v2_lite import hfl_readings

MODEL_KEYS = ("num_layers", "first_k_dense", "d_model", "num_heads", "num_kv_heads", "d_ff",
              "moe_d_ff", "num_experts", "experts_per_token", "experts_held", "experts_offset",
              "num_shared_experts", "kv_lora_rank", "q_lora_rank", "qk_nope_head_dim",
              "qk_rope_head_dim", "v_head_dim", "vocab_size", "norm_eps", "rope_theta",
              "yarn_factor", "yarn_original_max_pos", "yarn_beta_fast", "yarn_beta_slow",
              "yarn_mscale", "yarn_mscale_all_dim", "norm_topk_prob",
              "router_aux_loss_coef", "dtype", "remat")


def moe_weights(m: dict, seed: int, device):
    """DeepSeek-V2-Lite's weights in the port's tree layout, drawn as
    ``gen.lm_weights`` draws olmo's: scales 0.02 (embedding, head, router),
    1/√fan_in (projections); RMSNorm scales 1 (f32); the router f32."""
    g0 = gen.generator(seed, device, 0)
    dt = gen.DTYPES[m["dtype"]]
    d, H, V = m["d_model"], m["num_heads"], m["vocab_size"]
    r, dn, dr, dv = m["kv_lora_rank"], m["qk_nope_head_dim"], m["qk_rope_head_dim"], m["v_head_dim"]
    f, fe, Eh = m["d_ff"], m["moe_d_ff"], m["experts_held"]
    g = lambda shape, scale, dtype=dt: gen._normal(g0, shape, scale, dtype, device)
    ones = lambda *shape: torch.ones(shape, device=device)

    def block(L, ffn):
        return {"norm1": {"scale": ones(L, d)}, "norm2": {"scale": ones(L, d)},
                "attn": {"w_q": g((L, d, H * (dn + dr)), d ** -0.5),
                         "w_dkv": g((L, d, r + dr), d ** -0.5),
                         "kv_norm": {"scale": ones(L, r)},
                         "w_uk": g((L, r, H, dn), r ** -0.5), "w_uv": g((L, r, H, dv), r ** -0.5),
                         "wo": g((L, H * dv, d), (H * dv) ** -0.5)},
                "ffn": ffn(L)}

    def swiglu(lead, width):
        return {"w_gate": g(lead + (d, width), d ** -0.5), "w_up": g(lead + (d, width), d ** -0.5),
                "w_down": g(lead + (width, d), width ** -0.5)}

    def experts(L):
        return {"router": g((L, d, m["num_experts"]), 0.02, torch.float32),
                **swiglu((L, Eh), fe), "shared": swiglu((L,), fe * m["num_shared_experts"])}

    k = m["first_k_dense"]
    return {"embed": g((V, d), 0.02),
            "dense_blocks": block(k, lambda L: swiglu((L,), f)),
            "blocks": block(m["num_layers"] - k, experts),
            "final_norm": {"scale": ones(d)},
            "lm_head": g((d, V), 0.02)}


class Driver(lm_hfl.Driver):
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
        self.state = hfl_init(moe_weights(m, self.ctx.seed, dev), opt, self.hcfg)
        train = make_cluster_train_step(make_loss_fn(cfg), opt, constant_lr(h["lr"]))
        self.train, self.sync_step = self._faulty(train, make_sync(SyncPlan(self.hcfg)))
        self.pool = gen.lm_pool(m, self.t, h["clusters"], self.ctx.seed, dev)
        self.batches = ({"tokens": self.pool[i % len(self.pool)]} for i in itertools.count())
        N = h["clusters"]
        prog = {"loss": [], "grad1": None, "change": None}
        done = itertools.count()

        def on_step(_, state, losses):
            step = next(done)
            if step < self.followed:
                prog["loss"].append([float(v) for v in losses])
            if step == 0:
                prog["grad1"] = lm_hfl._norms_by_leaf(state.opt["m"], N)
            if step == self.followed - 1:
                w0 = moe_weights(m, self.ctx.seed, dev)
                ch = lm_hfl._norms_by_leaf(state.params, N, minus=w0)
                ch.update({"w_ref/" + k: v for k, v in
                           lm_hfl._norms_by_leaf(state.w_ref, None, minus=w0).items()})
                prog["change"] = ch
                del w0

        self._rounds(self.warm_rounds, on_step)
        self.prog = prog

    def window(self, seconds, traced):
        from repro_torch.models.moe import tally_load

        with tally_load() as load:
            win = super().window(seconds, traced)
        for held, slots in load.items():
            s = slots.double().cpu()  # the window's one read of the tally
            mean = float(s.mean())
            print(f"held-expert load over the window ({held} experts, {int(s.sum())} slots): "
                  f"largest {float(s.max()) / mean:.4f}, smallest {float(s.min()) / mean:.4f} "
                  f"of the mean", file=sys.stderr)
        return win

    def reference(self, lower=False):
        w0 = moe_weights(self.m, self.ctx.seed, self.ctx.device)
        return hfl_readings(w0, self.first, self.m, self.hfl, self.followed,
                            precision="fp8" if lower else "f32", rule=self.rule)
