"""The whole round's share of the bf16 peak in the MoE cells: three times the
forward's products of every token trained in the window
(``_moe_yardstick.forward_flops_per_token``; recomputation not counted) over
the window's time."""
from hflbench.metrics import _moe_yardstick as my
from hflbench.metrics import _yardstick as y


def read(ctx):
    i = ctx.info
    flops = 3 * my.forward_flops_per_token(ctx.config["model"], i["seq"]) * i["tokens"]
    return 100.0 * flops / (i["window_s"] * y.PEAK_BF16)
