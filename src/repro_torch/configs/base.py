"""Configuration schema for the PyTorch port.

A ``ModelConfig`` fully describes one architecture.  The field names and
defaults are those of the JAX package's config, so a ``.cfg.json`` written
beside a JAX checkpoint loads here unchanged; the port runs the dense
decoder and the mamba-2 (``arch_type="ssm"``) decoder and raises
``NotImplementedError`` on the fields it does not implement yet (MoE,
hybrid, encoder-decoder, VLM, ``window_pattern``).
``DiLoCoConfig`` and ``OptimizerConfig`` are field-for-field copies of the
JAX package's training configs; the port raises on the knobs whose code
paths it does not have yet (see ``core/outer_opt.py`` and ``core/sync.py``).

Frozen dataclasses, so configs hash and compare by value.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class ModelConfig:
    # identity ------------------------------------------------------------
    name: str = "model"
    arch_type: str = "dense"        # dense | moe | ssm | hybrid | audio | vlm
    source: str = ""                 # citation for the config values

    # trunk ----------------------------------------------------------------
    num_layers: int = 2
    d_model: int = 256
    num_heads: int = 4
    num_kv_heads: int = 4
    head_dim: int = 0                # 0 -> d_model // num_heads
    d_ff: int = 1024
    vocab_size: int = 512

    # attention ------------------------------------------------------------
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    # sliding window: 0 = full attention.  ``window_pattern`` gives a cycle of
    # per-layer windows (0 entries = global); empty -> uniform ``window``.
    window: int = 0
    window_pattern: Tuple[int, ...] = ()
    logit_soft_cap: float = 0.0

    # mlp -------------------------------------------------------------------
    mlp_activation: str = "swiglu"   # swiglu | relu2 | gelu
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    norm_eps: float = 1e-5
    tie_embeddings: bool = True

    # moe --------------------------------------------------------------------
    num_experts: int = 0
    num_experts_per_tok: int = 0
    num_shared_experts: int = 0
    moe_capacity_factor: float = 1.25
    router_aux_coef: float = 0.01

    # ssm (mamba-2 / SSD) -----------------------------------------------------
    ssm_state_size: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2              # d_inner = expand * d_model
    ssm_conv_width: int = 4
    ssm_chunk: int = 128

    # hybrid (hymba): parallel attention + SSM heads in every layer ----------
    hybrid: bool = False

    # encoder-decoder (seamless-m4t) ------------------------------------------
    is_encoder_decoder: bool = False
    num_encoder_layers: int = 0
    encoder_seq_len: int = 1024      # stubbed frontend: #frame embeddings

    # vlm (internvl2): patch embeddings prepended to the text sequence -------
    num_image_tokens: int = 0        # 0 -> pure text

    # vocab padding: embeddings/logits are padded to a multiple so the vocab
    # dim shards cleanly over the tensor-parallel axis (labels never hit the
    # pad ids; softmax learns to push them down).  1 = no padding (tests).
    vocab_pad_multiple: int = 1

    # numerics ----------------------------------------------------------------
    param_dtype: str = "float32"
    compute_dtype: str = "float32"   # dry-run overrides to bfloat16
    kv_cache_dtype: str = ""         # "" = compute dtype; bf16 = narrow cast;
                                     # int8 | fp8 | fp8_e5m2 = quantized paged
                                     # pool with per-token-per-head scales
    fp8_matmul: bool = False         # fp8 per-row QK^T in the paged
                                     # serving kernels (training ignores
                                     # it, as the JAX package's does)
    remat: bool = True
    use_scan: bool = True
    use_pallas: bool = False         # read by the JAX package only: on
                                     # the card the port always runs its
                                     # kernels (SSD included), on the CPU
                                     # their plain versions
    z_loss: float = 0.0
    loss_chunk: int = 0              # >0: chunked CE (never materializes the
                                     # full (B,S,V) logits) — see §Perf

    # -------------------------------------------------------------------------
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.num_heads

    def padded_vocab(self) -> int:
        m = max(self.vocab_pad_multiple, 1)
        return ((self.vocab_size + m - 1) // m) * m

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # parameter count estimate (for roofline MODEL_FLOPS = 6*N*D) -------------
    def param_count(self, active_only: bool = False) -> int:
        D = self.d_model
        hd = self.resolved_head_dim()
        n_q = self.num_heads * hd
        n_kv = self.num_kv_heads * hd
        attn = D * n_q + 2 * D * n_kv + n_q * D
        if self.qkv_bias:
            attn += n_q + 2 * n_kv
        if self.mlp_activation == "swiglu":
            mlp_dense = 3 * D * self.d_ff
        else:
            mlp_dense = 2 * D * self.d_ff
        if self.num_experts:
            e = self.num_experts_per_tok if active_only else self.num_experts
            e += self.num_shared_experts
            mlp = e * mlp_dense + D * self.num_experts   # + router
        else:
            mlp = mlp_dense
        ssm = 0
        if self.ssm_state_size:
            d_in = self.ssm_expand * D if not self.hybrid else n_q
            nh = d_in // self.ssm_head_dim
            # in_proj (z,x,B,C,dt) + conv + out_proj + A,D,dt_bias + gated norm
            conv_dim = d_in + 2 * self.ssm_state_size
            ssm = (D * (2 * d_in + 2 * self.ssm_state_size + nh)
                   + conv_dim * self.ssm_conv_width + d_in * D + 3 * nh + d_in)
        per_layer = 2 * D  # norms
        if self.hybrid:
            per_layer += attn + mlp + ssm
        elif self.ssm_state_size and self.arch_type == "ssm":
            per_layer = 2 * D + ssm  # attention-free; d_ff==0
        else:
            per_layer += attn + mlp
        total = self.num_layers * per_layer
        if self.is_encoder_decoder:
            # encoder layers (self-attn + mlp) + decoder cross-attn
            enc = self.num_encoder_layers * (attn + mlp_dense + 2 * D)
            cross = self.num_layers * (attn + D)
            total += enc + cross
        emb = self.vocab_size * D
        total += emb if self.tie_embeddings else 2 * emb
        total += D  # final norm
        return int(total)


@dataclass(frozen=True)
class DiLoCoConfig:
    """Hyper-parameters from the paper (§3)."""
    num_workers: int = 8
    h_inner_steps: int = 100          # H=100 base pretraining
    h_mid_sft: int = 30               # H=30 mid-training / SFT
    outer_lr: float = 0.8             # eta_outer
    outer_momentum: float = 0.9       # mu_outer (Nesterov)
    nesterov: bool = True
    # --- beyond-paper knobs ------------------------------------------------
    delta_dtype: str = "float32"      # float32 | bfloat16 | int8 | fp8 |
                                      # fp8_e5m2: the outer sync's wire
                                      # codec (core/transport.py)
    error_feedback: bool = True       # lossy codecs carry a per-worker
                                      # residual so quantization noise
                                      # cannot bias the outer optimizer
    grad_compress: str = "none"       # none | int8 | fp8 | fp8_e5m2: DDP-side
                                      # per-step update compression
    drift_aware: bool = False         # drift-weighted averaging (paper §5
                                      # future work)
    adaptive_h: bool = False          # adaptive H schedule (paper §5 future
                                      # work; not ported)
    h_min: int = 10
    h_max: int = 200
    # --- sync-strategy runtime (repro_torch.core.sync / DistTrainer) -------
    strategy: str = "diloco"          # ddp | ddp_compressed | diloco |
                                      # streaming | overlapped | pipelined
                                      # | gossip | async_gossip
    num_fragments: int = 4            # streaming/pipelined: F fragments
    sync_delay: int = 0               # overlapped/pipelined: steps between
                                      # delta capture and outer application
    h_jitter: int = 0                 # overlapped / async_gossip jitter
    sync_seed: int = 0                # seeds jitter draws and gossip peers
    topology: str = "ring"            # gossip peer schedule: ring | random
                                      # matching | full
    staleness_bound: int = 0          # async_gossip staleness bound


@dataclass(frozen=True)
class OptimizerConfig:
    """nanochat's optimizer split: Muon for matrices, AdamW for the rest."""
    learning_rate: float = 0.02       # muon lr
    adam_lr: float = 3e-4
    weight_decay: float = 0.0
    adam_betas: Tuple[float, float] = (0.9, 0.95)
    adam_eps: float = 1e-10
    muon_momentum: float = 0.95
    muon_ns_steps: int = 5
    grad_clip: float = 1.0
    fused_adamw: bool = False         # fused AdamW update kernel
                                      # (repro_torch.kernels.fused_adamw):
                                      # same update math
    warmup_steps: int = 32
    schedule: str = "wsd"             # wsd | cosine | constant
    total_steps: int = 1000
    final_lr_frac: float = 0.0
