"""``flash_attn_bwd`` (kernels/flash_attn: the dQ and the dK/dV launches) on
MLA's heads against the bf16 tensor-core peak: S again, dQ and dK at Dk =
dn + dr, dP and dV at Dv, each 2·T·S·D at the causal half."""
from hflbench.metrics import _moe_yardstick as my
from hflbench.metrics import _yardstick as y


def read(ctx):
    m, i = ctx.config["model"], ctx.info
    return y.flops_share(ctx.trace, ["dq_wgmma_kernel", "dkv_wgmma_kernel"], "dq_wgmma_kernel",
                         my.mla_attention_flops(m, i["rows"], i["seq"], 3, 2))
