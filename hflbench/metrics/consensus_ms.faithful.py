"""The consensus's device time (Alg. 5 l.22-39, core.federated): in the
profiled round, the device-busy time inside the sync iteration's span less
the mean inside the plain iterations' spans."""


def read(ctx):
    if ctx.trace is None or ctx.trace.busy_s <= 0:
        return None
    sync = ctx.trace.busy_in("hflbench.iteration.sync")
    plain = ctx.trace.busy_in("hflbench.iteration.plain")
    if not sync or not plain:
        return None
    return 1e3 * (sum(sync) / len(sync) - sum(plain) / len(plain))
