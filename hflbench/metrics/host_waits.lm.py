"""Blocking device->host reads a round: the program's ``wait.*`` spans
(core.sparsify's mask count, first_true's chunks, the exact top-k's radix
select, the fused selection's row checks) over the profiled rounds."""
from hflbench.metrics import _program as p


def read(ctx):
    if not p.present(ctx.trace):
        return None
    return p.count(ctx.trace, prefix="wait.") / p.units(ctx.info)[1]
