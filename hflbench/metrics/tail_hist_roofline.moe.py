"""``tail_hist`` (kernels/dgc, two launches a call) against HBM, counted as
``tail_hist_roofline.lm`` counts it, over DeepSeek-V2-Lite's flat row: Q is
the configuration's ``params``, every leaf of the port's tree."""
from hflbench.metrics import _yardstick as y


def read(ctx):
    q = y.tiles(ctx.config["model"]["params"])
    return y.bytes_share(ctx.trace, ["slice_hist_kernel", "tile_order_sum_kernel"],
                         "slice_hist_kernel", 4 * q + 8 * y.BINS)
