"""The whole round's share of the bf16 peak: three times the forward's products
of every token trained in the window (recomputation not counted) over the
window's time."""
from hflbench.metrics import _yardstick as y


def read(ctx):
    i = ctx.info
    flops = 3 * y.lm_forward_flops_per_token(ctx.config["model"], i["seq"]) * i["tokens"]
    return 100.0 * flops / (i["window_s"] * y.PEAK_BF16)
