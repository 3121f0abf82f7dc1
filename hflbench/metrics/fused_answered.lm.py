"""% of the fused selections (kernels.fused_sync.select_topk_rows) that the
block_select candidates answered: ``fused.select.candidates`` spans over
all ``fused.select.*`` outcome spans, one a call."""
from hflbench.metrics import _program as p


def read(ctx):
    if not p.present(ctx.trace):
        return None
    calls = p.count(ctx.trace, prefix="fused.select.")
    if not calls:
        return None
    return 100.0 * p.count(ctx.trace, "fused.select.candidates") / calls
