"""``update_max`` (kernels/dgc) against HBM, counted as
``update_max_roofline.lm`` counts it, over DeepSeek-V2-Lite's flat row: Q is
the configuration's ``params``, every leaf of the port's tree (the RMSNorm
scales among them)."""
from hflbench.metrics import _yardstick as y


def read(ctx):
    q = y.tiles(ctx.config["model"]["params"])
    return y.bytes_share(ctx.trace, ["update_max_kernel"], "update_max_kernel",
                         16 * q + 4 * q // y.TILE)
