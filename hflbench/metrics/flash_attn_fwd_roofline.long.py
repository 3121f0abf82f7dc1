"""``flash_attn_fwd`` (kernels/flash_attn) against the bf16 tensor-core peak:
the algorithm's two products (QK^T, PV) of one layer's call, each 2·T·S·d
at the causal half, for the cluster's rows."""
from hflbench.metrics import _yardstick as y


def read(ctx):
    m, i = ctx.config["model"], ctx.info
    return y.flops_share(ctx.trace, ["fwd_wgmma_kernel"], "fwd_wgmma_kernel",
                         y.attention_flops(m, i["rows"], i["seq"], 2))
