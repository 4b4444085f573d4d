"""command-r-plus-104b  [hf:CohereForAI/c4ai-command-r-v01 family]
dense, 64L, d_model=12288, 96 heads (GQA kv=8), d_ff=33792, vocab=256000,
no biases, tied embeddings.  The port's copy of
the JAX package's config."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="command-r-plus-104b",
    arch_type="dense",
    source="hf:CohereForAI/c4ai-command-r-plus",
    num_layers=64,
    d_model=12288,
    num_heads=96,
    num_kv_heads=8,
    head_dim=128,
    d_ff=33792,
    vocab_size=256000,
    qkv_bias=False,
    mlp_activation="swiglu",
    rope_theta=75000000.0,
    tie_embeddings=True,
)
