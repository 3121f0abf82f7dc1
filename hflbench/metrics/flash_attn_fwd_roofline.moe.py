"""``flash_attn_fwd`` (kernels/flash_attn) on MLA's heads against the bf16
tensor-core peak: QKᵀ at Dk = dn + dr and PV at Dv, each 2·T·S·D at the
causal half, for the cluster's rows."""
from hflbench.metrics import _moe_yardstick as my
from hflbench.metrics import _yardstick as y


def read(ctx):
    m, i = ctx.config["model"], ctx.info
    return y.flops_share(ctx.trace, ["fwd_wgmma_kernel"], "fwd_wgmma_kernel",
                         my.mla_attention_flops(m, i["rows"], i["seq"], 1, 1))
