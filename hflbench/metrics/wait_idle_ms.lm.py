"""Device-idle ms a round in the gaps that begin inside a ``wait.*`` span:
the queue a blocking read drained, until the host launched again."""
from hflbench.metrics import _program as p


def read(ctx):
    if not p.device_ok(ctx):
        return None
    return p.idle_ms_per(ctx, p.idle_s_from(ctx.trace, "wait."), 1)
