"""musicgen-medium [audio]: decoder-only over EnCodec tokens. 48L
d_model=1536 24H (kv=24) d_ff=6144 vocab=2048. Conditioning frontend
(text/melody embeddings) is the sanctioned stub: 256 precomputed frames.
[arXiv:2306.05284]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    arch_type="audio",
    num_layers=48,
    d_model=1536,
    num_heads=24,
    num_kv_heads=24,
    d_ff=6144,
    vocab_size=2048,
    head_dim=64,
    norm_type="layernorm",
    act="gelu",
    gated_mlp=False,
    frontend="audio_frames",
    frontend_tokens=256,
)
