"""deepseek-v2-236b [moe]: 60L d_model=5120 128H, MLA kv_lora=512
(q_lora=1536, rope 64 + nope 128, v 128), MoE 2 shared + 160 routed top-6
with per-expert d_ff=1536, vocab=102400. [arXiv:2405.04434]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    arch_type="moe",
    num_layers=60,
    d_model=5120,
    num_heads=128,
    num_kv_heads=128,
    d_ff=1536,
    vocab_size=102400,
    use_mla=True,
    kv_lora_rank=512,
    q_lora_rank=1536,
    qk_rope_head_dim=64,
    qk_nope_head_dim=128,
    v_head_dim=128,
    num_experts=160,
    experts_per_token=6,
    moe_d_ff=1536,
    num_shared_experts=2,
    norm_type="rmsnorm",
    act="silu",
)
