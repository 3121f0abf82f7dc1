"""Device-idle ms an iteration inside the per-MU passes (``faithful.mu_pass``,
core.federated: 28 f32 ResNet-18 forwards and backwards an iteration)."""
from hflbench.metrics import _program as p


def read(ctx):
    if not p.device_ok(ctx):
        return None
    return p.idle_ms_per(ctx, p.idle_s_in(ctx.trace, "faithful.mu_pass"), 1)
