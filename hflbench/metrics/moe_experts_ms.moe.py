"""Device ms a round of the held experts' grouped products (models.moe
``HeldExperts``): the operations launched inside ``moe.experts`` (forward
and remat's recompute) and ``moe.experts.backward``, over the profiled
rounds."""
from hflbench.metrics import _program as p

SPANS = ("moe.experts", "moe.experts.backward")


def read(ctx):
    if not p.device_ok(ctx) or not p.count(ctx.trace, SPANS[0]):
        return None
    return 1e3 * sum(p.device_s_launched_in(ctx.trace, s) for s in SPANS) / p.units(ctx.info)[1]
