"""``apply_mask`` (kernels/dgc) against HBM: each call reads u and v and the
threshold and writes the sent part, u'' and v'', 4 B an entry each over whole
tiles."""
from hflbench.metrics import _yardstick as y


def read(ctx):
    q = y.tiles(sum(ctx.info["sizes"]))
    return y.bytes_share(ctx.trace, ["apply_mask_kernel"], "apply_mask_kernel", 20 * q + 4)
