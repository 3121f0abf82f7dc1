"""Device time an iteration of the operations launched under the profiler's
convolution operations (ResNet-18's forward and backward, models.resnet)."""


def read(ctx):
    if ctx.trace is None:
        return None
    secs = ctx.trace.under_host_op("convolution")
    return 1e3 * secs / ctx.info["trace_iterations"] if secs > 0 else None
