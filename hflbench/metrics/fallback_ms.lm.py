"""Device ms a round of the fused selection's exact fallback
(kernels.fused_sync, the span ``fused.select.fallback`` around
``_exact_sort_rows``): the operations launched inside it over the profiled
rounds.  0 where every call of those rounds was answered from the
candidates."""
from hflbench.metrics import _program as p


def read(ctx):
    if not p.device_ok(ctx):
        return None
    return 1e3 * p.device_s_launched_in(ctx.trace, "fused.select.fallback") / p.units(
        ctx.info)[1]
