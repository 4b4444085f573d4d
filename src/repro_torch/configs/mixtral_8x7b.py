"""mixtral-8x7b  [arXiv:2401.04088]
MoE, 32L, d_model=4096, 32 heads (GQA kv=8), d_ff=14336, vocab=32000,
8 experts top-2, sliding-window attention (W=4096).  The port's copy of
the JAX package's config."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    arch_type="moe",
    source="arXiv:2401.04088 (Mixtral of Experts)",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32000,
    num_experts=8,
    num_experts_per_tok=2,
    window=4096,
    mlp_activation="swiglu",
    rope_theta=1000000.0,
    tie_embeddings=False,
)
