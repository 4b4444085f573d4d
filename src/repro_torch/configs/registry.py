"""Architecture ids -> ModelConfig, and the reduced smoke variants: the
JAX package's ``configs/registry.py`` ``get_config`` / ``get_reduced``,
every config the reference registers: nanochat-d20, the dense
qwen1.5-0.5b, command-r-plus-104b, nemotron-4-15b (squared-ReLU MLP)
and mistral-large-123b, the SSM mamba2-1.3b, the MoE mixtral-8x7b and
llama4-scout-17b-a16e, the encoder-decoder seamless-m4t-medium, the VLM
internvl2-26b and the hybrid hymba-1.5b.  The ids and their order are
the reference's (``_MODULES``); ``ARCH_IDS`` is every id but
nanochat-d20, as there.  Beside them, the dry run's shape helpers
(``long_context_variant``, ``decode_cache_capacity``, ``input_specs``,
``shape_by_name``), whose stand-ins are tensors on the ``meta`` device:
shapes and dtypes, no storage."""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Optional

import torch

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig

_MODULES: Dict[str, str] = {
    "nanochat-d20": "repro_torch.configs.nanochat_d20",
    "qwen1.5-0.5b": "repro_torch.configs.qwen15_05b",
    "mamba2-1.3b": "repro_torch.configs.mamba2_13b",
    "command-r-plus-104b": "repro_torch.configs.command_r_plus_104b",
    "nemotron-4-15b": "repro_torch.configs.nemotron4_15b",
    "mixtral-8x7b": "repro_torch.configs.mixtral_8x7b",
    "llama4-scout-17b-a16e": "repro_torch.configs.llama4_scout_17b_a16e",
    "seamless-m4t-medium": "repro_torch.configs.seamless_m4t_medium",
    "internvl2-26b": "repro_torch.configs.internvl2_26b",
    "hymba-1.5b": "repro_torch.configs.hymba_15b",
    "mistral-large-123b": "repro_torch.configs.mistral_large_123b",
}
ARCH_IDS = [k for k in _MODULES if k != "nanochat-d20"]
ALL_IDS = list(_MODULES)

# the sliding window a full-attention arch gets for long_500k decode (the
# reference's sub-quadratic variant)
LONG_CONTEXT_WINDOW = 8192


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _MODULES:
        raise NotImplementedError(f"arch {arch_id!r} is not registered; the "
                                  f"port has {ALL_IDS}")
    return importlib.import_module(_MODULES[arch_id]).CONFIG


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


def long_context_variant(cfg: ModelConfig) -> ModelConfig:
    """Sub-quadratic decode variant for long_500k: SSM unchanged; an
    attention arch gets a sliding window (ring-buffer KV cache)."""
    if cfg.arch_type == "ssm":
        return cfg
    if cfg.window and cfg.window <= LONG_CONTEXT_WINDOW:
        return cfg
    if cfg.window_pattern:
        pat = tuple(w if w else LONG_CONTEXT_WINDOW
                    for w in cfg.window_pattern)
        return cfg.with_(window_pattern=pat)
    return cfg.with_(window=LONG_CONTEXT_WINDOW, window_pattern=())


def decode_cache_capacity(cfg: ModelConfig, shape: ShapeConfig) -> int:
    """KV capacity a decode step sees: the full ``seq_len``, or the
    window for ring-buffer decode on long contexts."""
    if shape.sub_quadratic_required and cfg.arch_type != "ssm":
        ws = [cfg.window] if cfg.window else []
        if cfg.window_pattern:
            ws = [w if w else LONG_CONTEXT_WINDOW for w in cfg.window_pattern]
        w = max(ws) if ws else LONG_CONTEXT_WINDOW
        return min(shape.seq_len, max(w, 128))
    return shape.seq_len


def input_specs(cfg: ModelConfig, shape: ShapeConfig,
                batch_override: Optional[int] = None
                ) -> Dict[str, torch.Tensor]:
    """``meta`` tensors standing in for every model input, with the
    reference's shapes and dtypes: train / prefill take ``tokens`` and
    ``labels`` (B, S - image tokens) int32, a VLM's ``patches`` and an
    encoder-decoder's ``frames`` (B, n, d) in bf16 under a bf16 compute
    dtype (else f32); decode takes ``token`` (B, 1) and ``position``
    (B,)."""
    B = batch_override or shape.global_batch
    i32 = torch.int32

    def meta(dims, dtype):
        return torch.empty(dims, dtype=dtype, device="meta")

    if shape.kind in ("train", "prefill"):
        act = (torch.bfloat16 if cfg.compute_dtype == "bfloat16"
               else torch.float32)
        s_text = shape.seq_len
        specs: Dict[str, torch.Tensor] = {}
        if cfg.num_image_tokens:
            s_text -= cfg.num_image_tokens
            specs["patches"] = meta((B, cfg.num_image_tokens, cfg.d_model),
                                    act)
        if cfg.is_encoder_decoder:
            specs["frames"] = meta((B, cfg.encoder_seq_len, cfg.d_model), act)
        specs["tokens"] = meta((B, s_text), i32)
        specs["labels"] = meta((B, s_text), i32)
        return specs
    return {"token": meta((B, 1), i32), "position": meta((B,), i32)}


def shape_by_name(name: str) -> ShapeConfig:
    return SHAPES[name]
