"""The whole iteration's share of the f32 peak (TF32 off): three times the
forward's products of every image trained in the window over its time."""
from hflbench.metrics import _yardstick as y


def read(ctx):
    i = ctx.info
    flops = 3 * y.resnet_forward_flops(ctx.config["model"]) * i["images"]
    return 100.0 * flops / (i["window_s"] * y.PEAK_F32)
