"""mistral-large-123b  [hf:mistralai/Mistral-Large-Instruct-2407]
dense, 88L, d_model=12288, 96 heads (GQA kv=8), d_ff=28672, vocab=32768.
The port's copy of the JAX package's config."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mistral-large-123b",
    arch_type="dense",
    source="hf:mistralai/Mistral-Large-Instruct-2407",
    num_layers=88,
    d_model=12288,
    num_heads=96,
    num_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=32768,
    mlp_activation="swiglu",
    rope_theta=1000000.0,
    tie_embeddings=False,
)
