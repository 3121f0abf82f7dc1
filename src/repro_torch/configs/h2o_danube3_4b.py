"""h2o-danube-3-4b [dense]: 24L d_model=3840 32H (kv=8) d_ff=10240
vocab=32000 — llama+mistral mix with sliding-window attention (window 4096).
[arXiv:2401.16818]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-3-4b",
    arch_type="dense",
    num_layers=24,
    d_model=3840,
    num_heads=32,
    num_kv_heads=8,
    d_ff=10240,
    vocab_size=32000,
    head_dim=120,
    sliding_window=4096,
    norm_type="rmsnorm",
    act="silu",
)
