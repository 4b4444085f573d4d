"""qwen1.5-0.5b  [hf:Qwen/Qwen1.5-0.5B]
dense, 24L, d_model=1024, 16 heads (MHA: kv=16), d_ff=2816, vocab=151936,
QKV bias, tied embeddings.  The port's copy of
the JAX package's config."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-0.5b",
    arch_type="dense",
    source="hf:Qwen/Qwen1.5-0.5B",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=2816,
    vocab_size=151936,
    qkv_bias=True,
    mlp_activation="swiglu",
    rope_theta=1000000.0,
    tie_embeddings=True,
)
