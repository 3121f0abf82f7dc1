"""The held experts' products against the bf16 tensor-core peak: 12 products
of 2·d·f a slot (``_moe_yardstick.expert_flops_per_slot``) for the even
router's share of slots in every MoE layer of every cluster's step of the
profiled rounds, over the device time launched inside ``moe.experts`` and
``moe.experts.backward``."""
from hflbench.metrics import _moe_yardstick as my
from hflbench.metrics import _program as p
from hflbench.metrics import _yardstick as y

SPANS = ("moe.experts", "moe.experts.backward")


def read(ctx):
    if not p.device_ok(ctx) or not p.count(ctx.trace, SPANS[0]):
        return None
    secs = sum(p.device_s_launched_in(ctx.trace, s) for s in SPANS)
    m, i, t = ctx.config["model"], ctx.info, ctx.traffic
    steps = t["period"] * i["trace_rounds"] * ctx.config["hfl"]["clusters"]
    tokens = i["rows"] * i["seq"]
    flops = (steps * my.moe_layers(m) * tokens * my.held_slots_per_token(m)
             * my.expert_flops_per_slot(m))
    return 100.0 * flops / y.PEAK_BF16 / secs if secs > 0 else None
