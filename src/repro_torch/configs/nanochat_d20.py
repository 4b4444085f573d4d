"""nanochat d20 — the paper's own reference model (20 layers, 692.1 M
parameters with untied embeddings).

[github.com/karpathy/nanochat — depth-20 config: d_model = 64*depth = 1280,
 10 heads of 128, MLP 4x, vocab 2^16, rotary, untied embeddings]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="nanochat-d20",
    arch_type="dense",
    source="github:karpathy/nanochat (d20 speedrun config)",
    num_layers=20,
    d_model=1280,
    num_heads=10,
    num_kv_heads=10,
    head_dim=128,
    d_ff=5120,
    vocab_size=65536,
    mlp_activation="swiglu",
    rope_theta=10000.0,
    tie_embeddings=False,
)
