"""mamba2-780m [ssm]: attention-free SSD. 48L d_model=1536 (d_inner=3072,
headdim 64 -> 48 SSM heads) ssm_state=128 vocab=50280. [arXiv:2405.21060]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m",
    arch_type="ssm",
    num_layers=48,
    d_model=1536,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_headdim=64,
    ssm_ngroups=1,
    norm_type="rmsnorm",
    act="silu",
    tie_embeddings=True,
)
