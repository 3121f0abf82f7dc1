"""``tail_hist`` (kernels/dgc, two launches a call) against HBM: each call
reads the row once (4 B an entry over whole tiles) and the 64 edges, and
writes 64 f32 counts."""
from hflbench.metrics import _yardstick as y


def read(ctx):
    q = y.tiles(y.lm_flat_size(ctx.config["model"]))
    return y.bytes_share(ctx.trace, ["slice_hist_kernel", "tile_order_sum_kernel"],
                         "slice_hist_kernel", 4 * q + 8 * y.BINS)
