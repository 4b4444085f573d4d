"""internvl2-26b  [arXiv:2404.16821]
VLM, 48L internlm2-20b language backbone: d_model=6144, 48 heads (GQA kv=8),
d_ff=16384, vocab=92553.  The InternViT-6B vision tower + MLP projector are
STUBBED, as in the JAX package: the caller provides 256 projected patch
embeddings per image at d_model, prepended to the text sequence.  The
port's copy of the JAX package's config."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b",
    arch_type="vlm",
    source="arXiv:2404.16821 (InternVL2-26B, InternLM2-20B backbone)",
    num_layers=48,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=92553,
    num_image_tokens=256,
    mlp_activation="swiglu",
    rope_theta=1000000.0,
    tie_embeddings=False,
)
