"""``update_max`` (kernels/dgc) against HBM: each call of the sync's threshold
pass reads the row and one zero buffer (standing for u and g) and writes u'
and v', 4 B an entry each, over a row of Q padded to whole tiles, and one
f32 maximum a tile."""
from hflbench.metrics import _yardstick as y


def read(ctx):
    q = y.tiles(y.lm_flat_size(ctx.config["model"]))
    return y.bytes_share(ctx.trace, ["update_max_kernel"], "update_max_kernel",
                         16 * q + 4 * q // y.TILE)
