"""Device-idle ms a train step inside SGDM's update (``hfl.train.optimizer``):
the host's per-leaf loop leaves the device waiting there."""
from hflbench.metrics import _program as p


def read(ctx):
    if not p.steps_ok(ctx):
        return None
    return p.idle_ms_per(ctx, p.idle_s_in(ctx.trace, "hfl.train.optimizer"),
                         p.per_unit(ctx, "hfl.train_step"))
