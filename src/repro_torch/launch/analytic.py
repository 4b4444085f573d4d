"""Analytic FLOPs / HBM-traffic estimators per (architecture × input
shape): a copy of the JAX package's ``launch/analytic.py``, the roofline
terms of the port's dry run (``launch/dryrun_lib.py``), which has no
compiled program to take a cost analysis from.  All formulas are per
**device** on the given mesh and documented inline.

Conventions: matmul flops = 2·M·N·K; training does forward + backward
(2× forward) + one remat re-forward = 4× forward flops on matmuls
(nothing-saved checkpointing), i.e. the classic 6·N·D becomes 8·N·D with
full remat; we report both.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.configs.base import ModelConfig, ShapeConfig

TRAIN_MULT = 4.0      # fwd + re-fwd(remat) + bwd(2x)
TRAIN_MULT_NOREMAT = 3.0


def _attn_ctx(cfg: ModelConfig, S: int) -> float:
    """Average attended context per query under the config's windows."""
    if cfg.window_pattern:
        ws = [w if w else S for w in cfg.window_pattern]
        return sum(min(w, S) / (2 if w >= S else 1) for w in ws) / len(ws)
    if cfg.window:
        w = min(cfg.window, S)
        return w if w < S else S / 2
    return S / 2


def layer_flops_fwd_per_token(cfg: ModelConfig, S: int) -> float:
    """Forward matmul+attention flops per token per layer."""
    d = cfg.d_model
    hd = cfg.resolved_head_dim()
    nq, nkv = cfg.num_heads * hd, cfg.num_kv_heads * hd
    f = 0.0
    if cfg.arch_type != "ssm":
        f += 2.0 * d * (nq + 2 * nkv + nq)           # qkv + out proj
        ctx = _attn_ctx(cfg, S)
        f += 2.0 * 2.0 * nq * ctx                     # qk^T and pv
    if cfg.hybrid or cfg.arch_type == "ssm":
        d_in = (cfg.num_heads * hd) if cfg.hybrid else cfg.ssm_expand * d
        N = cfg.ssm_state_size
        H = d_in // cfg.ssm_head_dim
        P = cfg.ssm_head_dim
        Q = cfg.ssm_chunk
        f += 2.0 * d * (2 * d_in + 2 * N + H) + 2.0 * d_in * d  # in/out proj
        # SSD: intra-chunk (Q-causal attention in state space) + state path
        f += 2.0 * H * P * Q        # M @ xbar   (per token: Q/2 avg -> Q)
        f += 2.0 * N * Q            # C·B^T scores per token
        f += 4.0 * H * N * P / max(Q, 1) * Q  # state in/out ≈ 4·H·N·P
    if cfg.num_experts:
        e = cfg.num_experts_per_tok + cfg.num_shared_experts
        f += 2.0 * 3.0 * d * cfg.d_ff * e             # gated expert mlp
        f += 2.0 * d * cfg.num_experts                # router
    elif cfg.d_ff:
        n_mats = 3 if cfg.mlp_activation == "swiglu" else 2
        f += 2.0 * n_mats * d * cfg.d_ff
    return f


def flops_per_device(cfg: ModelConfig, shape: ShapeConfig, chips: int,
                     remat: bool = True) -> Dict[str, float]:
    S = shape.seq_len
    B = shape.global_batch
    d = cfg.d_model
    V = cfg.padded_vocab()

    if shape.kind == "decode":
        tokens = B                                    # one token per request
        ctx = (min(cfg.window or S, S) if cfg.arch_type != "ssm" else 0)
        # per-layer decode: projections + attention against ctx keys + mlp
        per_layer = layer_flops_fwd_per_token(cfg, max(ctx, 1) * 2)
        per_tok = cfg.num_layers * per_layer + 2.0 * d * V
        total = tokens * per_tok
        mult = 1.0
    else:
        tokens = S * B
        per_layer = layer_flops_fwd_per_token(cfg, S)
        per_tok = cfg.num_layers * per_layer + 2.0 * d * V
        if cfg.is_encoder_decoder:
            enc_tokens_ratio = cfg.encoder_seq_len / S
            per_tok += cfg.num_encoder_layers * layer_flops_fwd_per_token(
                cfg.with_(window=0, window_pattern=()), cfg.encoder_seq_len
            ) * enc_tokens_ratio
        total = tokens * per_tok
        mult = 1.0 if shape.kind == "prefill" else (
            TRAIN_MULT if remat else TRAIN_MULT_NOREMAT)
    return {"fwd_flops": total / chips,
            "total_flops": total * mult / chips,
            "model_flops_6nd": 6.0 * cfg.param_count(active_only=True)
            * tokens / chips}


def bytes_per_device(cfg: ModelConfig, shape: ShapeConfig, chips: int,
                     param_bytes: int = 2, cache_capacity: int = 0
                     ) -> Dict[str, float]:
    """HBM traffic per device per step (reads + writes)."""
    S, B = shape.seq_len, shape.global_batch
    d = cfg.d_model
    N = cfg.param_count()
    V = cfg.padded_vocab()
    act_w = 2                                          # bf16 activations

    if shape.kind == "decode":
        # every step streams all weights + the KV cache once
        cap = cache_capacity or S
        if cfg.arch_type == "ssm":
            d_in = cfg.ssm_expand * d
            H = d_in // cfg.ssm_head_dim
            cache = cfg.num_layers * B * (H * cfg.ssm_state_size
                                          * cfg.ssm_head_dim * 4
                                          + cfg.ssm_conv_width * d_in * 2) * 2
        else:
            hd = cfg.resolved_head_dim()
            cache = (cfg.num_layers * B * 2 * cap * cfg.num_kv_heads * hd
                     * act_w)
            if cfg.hybrid:
                H = cfg.num_heads
                cache += cfg.num_layers * B * (
                    H * cfg.ssm_state_size * cfg.ssm_head_dim * 4 * 2)
        traffic = N * param_bytes + cache + 3 * B * V * act_w
        return {"bytes": traffic / chips}

    tokens = S * B
    # weights: fwd read + remat re-read + bwd read + grad write/read +
    # optimizer state (muon mu f32 read+write) + param write
    w_traffic = N * (param_bytes * 3 + param_bytes * 2 + 4 * 2 + param_bytes)
    if shape.kind == "prefill":
        w_traffic = N * param_bytes
    # activations: per layer ~6 intermediate tensors of (tokens × d) each
    # written+read once in fwd (and again in remat+bwd for training)
    width = 6.0
    if cfg.num_experts:
        width += 2.0 * cfg.num_experts_per_tok * cfg.d_ff / d
    elif cfg.d_ff:
        width += 2.0 * cfg.d_ff / d
    if cfg.arch_type == "ssm" or cfg.hybrid:
        width += 4.0 * cfg.ssm_expand
    act_layer = tokens * d * act_w * width
    acts = cfg.num_layers * act_layer
    # saved residual stream (write fwd, read bwd)
    saved = cfg.num_layers * tokens * d * act_w * 2
    logits = 3 * tokens * V * act_w
    if shape.kind == "prefill":
        traffic = w_traffic + acts + logits / 3
    else:
        traffic = w_traffic + 2.5 * acts + saved + logits
    return {"bytes": traffic / chips}


def attention_kv_bytes(cfg: ModelConfig, S: int, B: int) -> float:
    hd = cfg.resolved_head_dim()
    return 2.0 * B * S * cfg.num_kv_heads * hd * 2
