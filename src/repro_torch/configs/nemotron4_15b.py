"""nemotron-4-15b  [arXiv:2402.16819]
dense, 32L, d_model=6144, 48 heads (GQA kv=8), d_ff=24576, vocab=256000,
squared-ReLU MLP (no gating).  The port's copy of
the JAX package's config."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-15b",
    arch_type="dense",
    source="arXiv:2402.16819 (Nemotron-4 15B)",
    num_layers=32,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=256000,
    mlp_activation="relu2",
    rope_theta=10000.0,
    tie_embeddings=False,
)
