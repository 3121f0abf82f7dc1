"""Share of a iteration with no operation on the device: the profiled iterations'
busy time against the time of one in the window that follows them."""
from hflbench.metrics import _yardstick as y


def read(ctx):
    i = ctx.info
    return y.idle_share(ctx.trace, i["trace_iterations"], i["window_s"] / i["iterations"])
