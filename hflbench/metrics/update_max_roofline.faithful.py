"""``update_max`` (kernels/dgc) against HBM: every call (each Omega's threshold
pass) reads the vector and one zero buffer and writes u' and v', 4 B an entry
each over whole tiles, and one f32 maximum a tile."""
from hflbench.metrics import _yardstick as y


def read(ctx):
    q = y.tiles(sum(ctx.info["sizes"]))
    return y.bytes_share(ctx.trace, ["update_max_kernel"], "update_max_kernel",
                         16 * q + 4 * q // y.TILE)
