"""mamba2-1.3b  [arXiv:2405.21060]
SSM (attention-free), 48L, d_model=2048, SSD state=128, head_dim=64,
expand=2 (d_inner=4096, 64 SSD heads), vocab=50280.  The port's copy of
the JAX package's config."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    arch_type="ssm",
    source="arXiv:2405.21060 (Mamba-2 1.3B)",
    num_layers=48,
    d_model=2048,
    num_heads=32,          # unused by SSM blocks; kept for API uniformity
    num_kv_heads=32,
    d_ff=0,                # attention-free, no MLP (per assignment spec)
    vocab_size=50280,
    ssm_state_size=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_conv_width=4,
    ssm_chunk=128,
    tie_embeddings=True,
)
