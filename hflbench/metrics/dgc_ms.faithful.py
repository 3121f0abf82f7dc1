"""Device ms an iteration that the MUs' DGC steps (``faithful.dgc``:
update_max, tail_hist, apply_mask and their glue) launched."""
from hflbench.metrics import _program as p


def read(ctx):
    if not p.device_ok(ctx):
        return None
    n = p.count(ctx.trace, "faithful.iteration")
    return 1e3 * p.device_s_launched_in(ctx.trace, "faithful.dgc") / n if n else None
