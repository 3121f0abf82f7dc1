"""Device ms a round of the expert layer's routing and combine (models.moe
``held_moe_forward``): the operations launched inside ``moe.route`` (router,
top-K, the held slots' rows) and ``moe.combine`` (the gate-weighted sum),
over the profiled rounds."""
from hflbench.metrics import _program as p

SPANS = ("moe.route", "moe.combine")


def read(ctx):
    if not p.device_ok(ctx) or not p.count(ctx.trace, SPANS[0]):
        return None
    return 1e3 * sum(p.device_s_launched_in(ctx.trace, s) for s in SPANS) / p.units(ctx.info)[1]
