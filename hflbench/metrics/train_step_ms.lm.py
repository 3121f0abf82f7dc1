"""Mean time of the cluster train step (``core.hfl``), synchronized at both ends."""


def read(ctx):
    return ctx.spans.mean_ms("train_step") if ctx.spans else None
