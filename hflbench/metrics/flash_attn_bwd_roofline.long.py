"""``flash_attn_bwd`` (kernels/flash_attn: the dQ and the dK/dV launches)
against the bf16 tensor-core peak: the algorithm's five products (S once
again, dP, dV, dQ, dK), each 2·T·S·d at the causal half."""
from hflbench.metrics import _yardstick as y


def read(ctx):
    m, i = ctx.config["model"], ctx.info
    return y.flops_share(ctx.trace, ["dq_wgmma_kernel", "dkv_wgmma_kernel"], "dq_wgmma_kernel",
                         y.attention_flops(m, i["rows"], i["seq"], 5))
