"""hymba-1.5b  [arXiv:2411.13676]
hybrid-head: every layer runs attention heads and SSM (mamba) heads in
PARALLEL on the same input, outputs normalized and mixed.  32L,
d_model=1600, 25 heads of 64 (GQA kv=5), d_ff=5504, vocab=32001,
ssm_state=16.  Sliding window (1024) everywhere except 3 global-attention
layers (first / middle / last).  Meta-tokens are simplified away, as in
the JAX package.  The port's copy of the JAX package's config."""
from repro_torch.configs.base import ModelConfig

_L = 32
_WINDOWS = tuple(0 if i in (0, _L // 2, _L - 1) else 1024 for i in range(_L))

CONFIG = ModelConfig(
    name="hymba-1.5b",
    arch_type="hybrid",
    source="arXiv:2411.13676 (Hymba-1.5B)",
    num_layers=_L,
    d_model=1600,
    num_heads=25,
    num_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32001,
    hybrid=True,
    ssm_state_size=16,
    ssm_head_dim=64,
    ssm_conv_width=4,
    ssm_chunk=128,
    window_pattern=_WINDOWS,
    mlp_activation="swiglu",
    tie_embeddings=True,
)
