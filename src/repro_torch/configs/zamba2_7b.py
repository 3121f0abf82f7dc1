"""zamba2-7b [hybrid]: Mamba2 backbone + ONE shared attention block reused
every 6 layers. 81L d_model=3584 32H (kv=32) d_ff=14336 vocab=32000
ssm_state=64. [arXiv:2411.15242]

Long-context note (DESIGN.md §4): the shared attention uses a 4096 sliding
window so the arch stays sub-quadratic for long_500k (the real model bounds
attention cost by applying it at only ~1/6 of layers; we additionally window
it — documented deviation).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    arch_type="hybrid",
    num_layers=81,
    d_model=3584,
    num_heads=32,
    num_kv_heads=32,
    d_ff=14336,
    vocab_size=32000,
    head_dim=112,
    ssm_state=64,
    ssm_expand=2,
    ssm_headdim=64,
    ssm_ngroups=1,
    attn_every=6,
    sliding_window=4096,
    norm_type="rmsnorm",
    act="silu",
)
