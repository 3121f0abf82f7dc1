"""deepseek-v2-lite [moe]: 27L d_model=2048 16H, MLA kv_lora=512 without a
query LoRA (rope 64 + nope 128, v 128), YaRN (factor 40 over 4,096, beta
32/1, mscale 0.707); layer 0 a dense SwiGLU of 10,944, then 26 layers of 2
shared + 64 routed experts of 1,408, softmax top-6 without renormalising,
dropless, a per-sequence balance loss (alpha 0.001); vocab=102400, untied
head. [arXiv:2405.04434; huggingface.co/deepseek-ai/DeepSeek-V2-Lite
config.json] The port's own entry: the reference has no such config."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite",
    arch_type="moe",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=10944,
    vocab_size=102400,
    use_mla=True,
    kv_lora_rank=512,
    q_lora_rank=0,
    qk_rope_head_dim=64,
    qk_nope_head_dim=128,
    v_head_dim=128,
    rope_theta=10000.0,
    yarn_factor=40.0,
    yarn_original_max_pos=4096,
    yarn_beta_fast=32.0,
    yarn_beta_slow=1.0,
    yarn_mscale=0.707,
    yarn_mscale_all_dim=0.707,
    num_experts=64,
    experts_per_token=6,
    moe_d_ff=1408,
    num_shared_experts=2,
    router_aux_loss_coef=0.001,
    dropless=True,
    norm_topk_prob=False,
    first_k_dense=1,
    norm_type="rmsnorm",
    norm_eps=1e-6,
    act="silu",
    tie_embeddings=False,
)
