"""seamless-m4t-medium  [arXiv:2308.11596]
audio encoder-decoder, 12L (12 enc + 12 dec), d_model=1024, 16 heads (kv=16),
d_ff=4096, vocab=256206, LayerNorm, gelu MLP.  The speech frontend (mel +
conformer conv) is STUBBED, as in the JAX package: the caller provides
precomputed frame embeddings (B, 1024, d_model), which the transformer
backbone consumes.  The port's copy of the JAX package's config."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    arch_type="audio",
    source="arXiv:2308.11596 (SeamlessM4T medium)",
    num_layers=12,
    num_encoder_layers=12,
    is_encoder_decoder=True,
    encoder_seq_len=1024,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=256206,
    mlp_activation="gelu",
    norm="layernorm",
    tie_embeddings=True,
)
