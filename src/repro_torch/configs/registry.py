"""Architecture ids -> ModelConfig, and the reduced smoke variants: the
JAX package's ``configs/registry.py`` ``get_config`` / ``get_reduced``,
limited to the configs the port registers, every decoder-only one:
nanochat-d20, the dense qwen1.5-0.5b, command-r-plus-104b,
nemotron-4-15b (squared-ReLU MLP) and mistral-large-123b, the SSM
mamba2-1.3b, the MoE mixtral-8x7b and llama4-scout-17b-a16e, and the
hybrid hymba-1.5b.  The ids and their order are the reference's."""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.command_r_plus_104b import \
    CONFIG as COMMAND_R_PLUS_104B
from repro_torch.configs.hymba_15b import CONFIG as HYMBA_15B
from repro_torch.configs.llama4_scout_17b_a16e import \
    CONFIG as LLAMA4_SCOUT_17B_A16E
from repro_torch.configs.mamba2_13b import CONFIG as MAMBA2_13B
from repro_torch.configs.mistral_large_123b import \
    CONFIG as MISTRAL_LARGE_123B
from repro_torch.configs.mixtral_8x7b import CONFIG as MIXTRAL_8X7B
from repro_torch.configs.nanochat_d20 import CONFIG as NANOCHAT_D20
from repro_torch.configs.nemotron4_15b import CONFIG as NEMOTRON4_15B
from repro_torch.configs.qwen15_05b import CONFIG as QWEN15_05B

_CONFIGS: Dict[str, ModelConfig] = {
    "nanochat-d20": NANOCHAT_D20,
    "qwen1.5-0.5b": QWEN15_05B,
    "mamba2-1.3b": MAMBA2_13B,
    "command-r-plus-104b": COMMAND_R_PLUS_104B,
    "nemotron-4-15b": NEMOTRON4_15B,
    "mixtral-8x7b": MIXTRAL_8X7B,
    "llama4-scout-17b-a16e": LLAMA4_SCOUT_17B_A16E,
    "hymba-1.5b": HYMBA_15B,
    "mistral-large-123b": MISTRAL_LARGE_123B,
}
ALL_IDS = list(_CONFIGS)


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _CONFIGS:
        raise NotImplementedError(f"arch {arch_id!r} is not ported; the "
                                  f"port has {ALL_IDS}")
    return _CONFIGS[arch_id]


def get_reduced(arch_id: str) -> ModelConfig:
    """Reduced variant of the same family: 2 layers, d_model<=256, <=4
    experts — runs a CPU forward/train step in the smoke tests."""
    c = get_config(arch_id)
    hd = 32
    heads = min(c.num_heads, 4)
    kv = max(1, min(c.num_kv_heads, heads))
    if c.num_heads % c.num_kv_heads == 0:
        kv = max(1, heads // max(1, c.num_heads // c.num_kv_heads))
    d_model = heads * hd * 2          # keep d_model != heads*hd to catch bugs
    red = dataclasses.replace(
        c,
        num_layers=2,
        d_model=d_model,
        num_heads=heads,
        num_kv_heads=kv,
        head_dim=hd,
        d_ff=0 if c.d_ff == 0 else 4 * d_model,
        vocab_size=512,
        num_experts=min(c.num_experts, 4),
        num_experts_per_tok=min(c.num_experts_per_tok, 2),
        ssm_state_size=min(c.ssm_state_size, 32),
        ssm_head_dim=16 if c.ssm_state_size else c.ssm_head_dim,
        ssm_chunk=32,
        num_encoder_layers=2 if c.is_encoder_decoder else 0,
        encoder_seq_len=32 if c.is_encoder_decoder else c.encoder_seq_len,
        num_image_tokens=16 if c.num_image_tokens else 0,
        window=min(c.window, 32) if c.window else 0,
        window_pattern=tuple(min(w, 32) if w else 0
                             for w in c.window_pattern[:2]) if c.window_pattern else (),
        rope_theta=10000.0,
    )
    return red
