"""Mean time of the flat sparse sync (``core.hfl``), synchronized at both ends."""


def read(ctx):
    return ctx.spans.mean_ms("sync") if ctx.spans else None
