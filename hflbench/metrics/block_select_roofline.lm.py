"""``block_select`` (kernels/fused_sync) against HBM: each call of the sync's
exact selection reads the row and writes its fixed candidate slots and
counts; every row of the LM sync keeps k = (1 - 0.9)·Q."""
from hflbench.metrics import _yardstick as y


def read(ctx):
    q = y.lm_flat_size(ctx.config["model"])
    phi = ctx.config["hfl"]["phi"]
    if phi[2] != phi[3]:  # the uplink and downlink rows keep the same k
        return None
    return y.bytes_share(ctx.trace, ["select_kernel"], "select_kernel",
                         y.block_select_bytes(q, y.keep_count(q, phi[2])))
