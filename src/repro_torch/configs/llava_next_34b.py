"""llava-next-34b [vlm]: 60L d_model=7168 56H (kv=8) d_ff=20480 vocab=64000.
AnyRes tiling: the vision tower + projector are the sanctioned stub; the
frontend supplies 576 base-grid patch embeddings (24x24) which the decoder
consumes through a learned projector. [hf:llava-hf/llava-v1.6-mistral-7b-hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b",
    arch_type="vlm",
    num_layers=60,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    d_ff=20480,
    vocab_size=64000,
    head_dim=128,
    norm_type="rmsnorm",
    act="silu",
    frontend="vision_patches",
    frontend_tokens=576,
)
