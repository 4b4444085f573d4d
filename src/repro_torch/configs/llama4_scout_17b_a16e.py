"""llama4-scout-17b-a16e  [hf:meta-llama/Llama-4-Scout-17B-16E]
MoE, 48L, d_model=5120, 40 heads (GQA kv=8), d_ff=8192 (per expert),
vocab=202048, 16 experts top-1 + 1 shared expert, chunked local attention
(iRoPE: 3 local : 1 global) modeled as window_pattern (8192,8192,8192,0).
The port's copy of the JAX package's config."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    arch_type="moe",
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    num_experts=16,
    num_experts_per_tok=1,
    num_shared_experts=1,
    window_pattern=(8192, 8192, 8192, 0),
    mlp_activation="swiglu",
    rope_theta=500000.0,
    tie_embeddings=False,
)
