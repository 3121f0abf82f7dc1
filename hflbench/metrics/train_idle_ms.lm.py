"""Device-idle ms a train step inside the program's ``hfl.train_step``
(core.hfl's cluster train step): the clean window's idle time a round, by
the step spans' share of the profiled idle time, over the steps a round."""
from hflbench.metrics import _program as p


def read(ctx):
    if not p.steps_ok(ctx):
        return None
    return p.idle_ms_per(ctx, p.idle_s_in(ctx.trace, "hfl.train_step"),
                         p.per_unit(ctx, "hfl.train_step"))
