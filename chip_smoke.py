#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (built for H100).

    python3 chip_smoke.py [--out report.json]
    python3 chip_smoke.py --norm-timing | --ssd-timing

Run from the root of a checkout.  First logs the kernels that SDPA
launches at the training shape (torch.profiler), the flash rows'
yardstick.  Then phases, each fatal on failure:

1. build every CUDA source of the port (``src/repro_torch/kernels/csrc``),
   one nvcc per source, all started together;
2. hold each kernel against its plain PyTorch version on the card:
   - serving kernels at nanochat-d20 shapes (S=8 slots, KV=10, G=1,
     D=128, bs=16, MB=32; ragged positions, unmapped blocks, inactive
     slots), plus a G=2 case and a sliding-window case; the same cases
     for the dequant kernels on int8, fp8_e4m3 and fp8_e5m2 pools, the
     fp8 QK^T kernels on f32 and bf16 pools, and the plain kernels on a
     bf16 pool under f32 queries; and the split kernels' invariant: paged
     verify row t equals paged decode at start + t, bit for bit, on f32,
     bf16, int8, fp8_e4m3 and fp8_e5m2 pools and with the fp8 QK^T, G 1
     and 2, window 0 and 64, over a cache of 8 chunks with verify ranges
     straddling chunk boundaries;
   - training kernels: flash forward and backward at (B 4, S 1024,
     H = KV = 10, D 128) plus G=2, S=1000 and window=256 cases (the
     backward against autograd through the plain forward); fused AdamW on
     the AdamW partition's largest leaf (65536 x 1280) and an odd-length
     leaf; the RMSNorm backward, plain and residual, at 4096 x 1280
     against autograd of the plain norms;
   all in float32 and bfloat16 (fused AdamW: f32 and bf16 gradients);
   - the outer-sync wire kernels, quantize_ef (codes, residual, scales)
     and dequantize, bit for bit, for int8, fp8_e4m3 and fp8_e5m2: at
     (2, 131,072,000) (the layers/mlp/w_up leaf of two workers) with a
     residual, at (1, 1280), on a scalar leaf, and per tile (256);
   - the static path's kernels: the SSD chunk scan at mamba2-1.3b's
     shapes (B 2, H 64, P 64, N 128; S 512, S 300 (padding), S 64
     (Q 64); scoring's B 4, S 144) and small ragged shapes (Q 8, 32
     and 37, N 4 and 32, P 8 and 16) within 1e-4 + 1e-4 in f32, the
     same bits on a second call, and the ring decode at (B 8,
     KV 10, G 1, S 320, D 128) with window 0 and 64 over a wrapped ring
     with empty slots (the row whose query sits at -1 gives zeros and is
     not compared), a chunk of dead slots, a window starting mid-chunk
     and S 200 (not a multiple of the chunk);
   - the fp8 QK^T flash forward (``flash_fwd(fp8=True)``) against its
     plain version at (B 4, S 1024, H = KV = 10, D 128), causal, plus
     G=2, S=1000 and window=64 cases, f32 and bf16, with the flash
     forward's tolerances; its output must differ from the exact
     kernel's by more than 1e-3;
   - flash forward and backward at the training shape, f32 and bf16: a
     second call with the same inputs gives the same bits (no atomics);
   - the RMSNorm kernels at every layout (``NORM_WIDTHS``: warp-wide rows
     to 2048, CTA-wide to 12288) over ``NORM_ROWS`` rows, forward and
     backward, f32 and bf16; a row's bits independent of the launch (40
     rows at once, as 8-row slices and one by one: forward outputs and
     backward dx); the backward's dx and dscale the same bits on a
     second call; widths the layout does not take refused;
   each check logs its worst ratio of error to the tolerance's allowance
   (``gate_ratio``; ``bits`` where it compares bit for bit);
3. full width at depth 2, card against CPU, same params and batch:
   - one ``decode_step_paged`` and one ``verify_step_paged``, on an f32
     pool and on an fp8 pool (logits; the fp8 pool within one quantum);
   - one training step: the loss, every gradient, one
     ``nanochat_optimizer`` update with fused AdamW, and one DiLoCo outer
     round (K=2, H=1);
   - one DiLoCo outer round (K=2, H=1) with an int8 and an fp8 wire:
     from each device's own inner step every code within its deltas'
     distance on the code grid plus one, at most 1e-5 of the codes more
     than one step apart, scales within the amaxes' gap plus 1e-6 (codes
     that differ counted, and those far apart by optimizer partition and
     by AdamW gradient size); from one state, the new anchor, momentum
     and residual equal bit for bit;
   - the static path: mamba2-1.3b's ``forward_lm`` (2 x 200 tokens), and
     for mamba2-1.3b and nanochat-d20 a 12-token static prefill plus one
     ``decode_step_lm`` (logits 2e-3; SSM state, conv ring, ring K/V
     within 1e-4 of their max);
4. the serving main path: ``repro_torch.Engine`` with the full
   nanochat-d20 config (seeded random params, 8 ragged token-id requests,
   max_new 32; 16 off the f32 pool) with spec_k=0 and spec_k=4, on an f32
   pool, on int8, fp8
   and fp8_e5m2 pools and with the fp8 QK^T; greedy tokens must be equal
   between spec_k 0 and 4 on each, spec_k=4 must have drafted, every
   kernel of each run must have launched and no other paged kernel
   (counts reset just before each run); token agreement with the f32
   stream is printed; then one shorter spec_k=0 run on an f32 and on an
   fp8 pool under torch.profiler for the device time by kernel and busy
   share, and the capacity of an f32 and an fp8 pool at one byte budget
   (blocks and peak admitted requests); then the static-bucket path:
   mamba2-1.3b at full width and depth (48 layers, seeded random
   params) serves the same 8 requests through ``Engine.generate`` (an
   SSM has no paged cache; max_new 16) and scores 4 rows (one over 128
   tokens, one under 64) with ``score_continuations_batch`` (the SSD
   kernel once per layer; no paged or flash kernel on either), one
   short static run and one scoring call under torch.profiler (device
   time by kernel, busy share); nanochat-d20 serves the 8
   requests on an engine too small for them (max_len 256), so the batch
   takes the static path and the ring decode kernel, and on a batch that
   fits the share of greedy tokens equal between the static path and
   the scheduler is printed (not gated);
4b. the dense configs besides nanochat-d20 at full published widths,
   heads and vocabularies (f32, random weights from seed 0), one at a
   time: qwen1.5-0.5b at full depth (24 layers; QKV bias, tied 151,936
   rows, 16 heads of 64), command-r-plus-104b at 2 layers, mistral-large
   -123b at 4 and nemotron-4-15b (squared-ReLU MLP) at 8 (~25 GB each:
   415 / 490 / 62.5 GB at full depth); first the paged kernels at their
   new (KV, G, D) (16, 1, 64), (8, 12, 128), (8, 6, 128), verify at T 5,
   and flash at qwen's step shape (B 4, S 256, H 16, D 64) against the
   plain versions; then phase 4's 8 requests (16 new tokens) through
   ``Engine`` at spec_k 0 and 4 and ``generate_ids_static``: finite
   logits, greedy tokens equal across the three, each engine run
   launching the norms and its paged kernel and no other kernel;
   tokens/s, ms a step and peak memory; qwen also trains one DiLoCo
   round at full depth (K 2, H 2, 4 x 256 tokens a worker, fused AdamW;
   the loss falls, the training kernels and no other) and its depth-2
   training step is held against the CPU as in phase 3;
5. the training main path at full nanochat-d20 (20 layers, float32,
   random params from seed 0) on the port's synthetic corpus through its
   ``PackedDataset`` at seq_len 1024: ``run_stage("diloco")`` with K=2,
   per-worker batch 4, H=2, 4 steps and fused AdamW, then
   ``run_stage("ddp")`` for 2 steps at global batch 8; then the lossy
   wire: DiLoCo (H=2, 4 steps) with int8, fp8 and fp8_e5m2 wires, DDP
   with ``grad_compress`` fp8 (K=2, 2 steps), and with int8 wires
   streaming (F=2), overlapped (delay 1) and pipelined (F=2, delay 1),
   4 steps each.  Every training kernel must have launched on each path
   (and quantize_ef and dequantize on each lossy one), losses must be
   finite and fall, sync records as expected; tokens/s, step seconds,
   peak memory and wire bytes per worker per sync (from
   ``OuterPayload.nbytes``) per path; one DiLoCo inner step under
   torch.profiler; the device time of one outer sync of each path;
6. the three-stage pipeline: ``run_pipeline`` (base -> mid -> SFT, with
   the evals after each stage: held-out CE, multiple choice, arithmetic
   and pattern exact match through ``Engine``) of nanochat-d20 at full
   width (20 layers, d 1280, 10 heads of 128; vocab = the tokenizer's
   512, as the JAX pipeline sets it) for DiLoCo and for hybrid (DiLoCo
   base, DDP mid and SFT), K 4, per-worker batch 8, seq_len 128, steps
   6 / 4 / 4, fused AdamW, remat on (the config's default: the forward
   kernels launch again in the backward), each from fresh parameters:
   per stage the
   loss, step seconds, tokens/s, peak memory, held-out CE, the suite's
   values and the eval seconds; gates on the losses, the stage methods,
   the launches (the training kernels and the paged decode of the evals;
   no verify, quantized-pool, wire, ssd, ring or fp8 kernel), the eval
   values, and the final checkpoint reloaded to the same held-out CE bit
   for bit; the hybrid run's final parameters on the CPU: held-out CE
   within rtol 1e-4, MC option scores within 1e-3 of their magnitude,
   greedy-token agreement printed;
6b. the run machinery and the paper's diagnostics:
   - remat at nanochat-d20's full width and depth (vocab 65536), phase
     5's shape (4 x 1024 tokens): one training step with remat off and
     on, the loss and every gradient equal bit for bit, the forward
     kernels launched twice under remat and the backward's once; the
     peak memory and seconds of one DiLoCo round (H 1, fused AdamW) at
     K 2 with remat off and on and at K 4 with remat on, and off when
     the K 2 and K 4 peaks reckon it fits;
   - resume at depth 2 and full width (vocab 512), K 2, H 2, 4 steps on
     the int8 wire, DiLoCo and pipelined (F 2, delay 1): a checkpoint
     every 2 steps (pipelined defers the one at step 2: a fragment is in
     flight), a run resumed from the first checkpoint into fresh state
     equal to the uninterrupted run bit for bit (the anchor, outer
     momentum, every worker's parameters and optimizer state, and the
     error-feedback residual), in a temporary directory under build/;
   - prefetch 4 with the eval hook every 3 steps: the same bits as
     prefetch 0, the hook called at step 2;
   - drift: a DiLoCo run of nanochat-d20 at full width, 10 layers (vocab
     512, K 4, H 2, 4 steps of 8 x 128 tokens a worker) measured before
     its last sync: ``param_drift`` against the same function on
     float64 CPU copies (rtol 1e-5), ``worker_cka_matrix`` of the
     ``forward_hidden`` probe on an 8 x 128 batch against the same on
     float64 CPU copies of the hidden states (rtol 1e-4), and workers 0
     and 1's ``linear_cka`` and ``subspace_overlap`` (r 8) logged;
   the launch counts of each run read for phase 7's table;
6c. gossip and async gossip over the codec wire (int8), nanochat-d20 at
   full width (vocab 512), K 4, per-worker batch 8, seq_len 128, H 2,
   fused AdamW, remat on, through ``run_stage``: gossip on the ring and
   the random topology (20 layers, 4 steps each) and async gossip
   (jitter 1, bound 1, 6 steps) at full depth when the gossip run's peak
   plus its three publication boards reckon it fits, else at 10 layers;
   gates: losses finite and falling, the ``gossip_syncs`` and
   ``sync_steps`` records equal to the same run's on the CPU (a tiny
   model), the training and wire kernels launched and no other, the
   counted wire bytes equal to the records' reads (per worker per round,
   for gossip: ``payload_schedule``'s plus the scales' 4 bytes a leaf);
   step seconds and peak memory logged; at depth 2, async gossip with
   jitter 0 and bound 0 equal to gossip bit for bit, and resume ==
   uninterrupted bit for bit for both (state, anchors, momentum,
   residual, boards); then ``comm_report`` for diloco (phase 6's base
   step), gossip and async gossip over worker speeds (1, 1, 1.5, 2) on
   Table 1's base stage (300 steps, H 100), beside the link it assumes;
6d. the fault layer at phase 6c's shape (nanochat-d20, full width, vocab
   512, K 4, per-worker batch 8, seq_len 128, H 2, int8 wire, fused
   AdamW, remat on) through ``run_stage(faults=...)``, both cut to 10
   layers for the script's time: DiLoCo for 8 steps
   under ``slow:3@1x1.5,crash:2@2,drop:1@3,corrupt:0@5x2,rejoin:2@6`` and
   gossip (ring) for 4 under
   ``crash:1@1,rejoin:1@2``; gates: the quorum
   and sync records, the fault / quorum / sync / gossip records equal to
   a tiny CPU run's, one rejoin record whose norm and cosine are within
   1e-5 of float64 CPU copies of the pre-adoption state, the down worker
   holding its parameters of the crash until its rejoin and its
   optimizer state ``init`` after it, losses finite, the training and
   wire kernels launched and no other, and each inner step with the
   worker down launching 3/4 of an all-live step's training kernels;
   step seconds and peak memory logged; at depth 2, bit for bit: an
   empty schedule and a one-attempt drop == the fault-free run, one dead
   worker of K 4 == the K 3 fleet of the others (f32 wire), kill@3 ->
   resume == uninterrupted for DiLoCo, DDP, streaming and pipelined (the
   last with a crash and a rejoin), and a ``min_quorum`` skip leaves the
   anchor at its init (DiLoCo K 2, gossip K 4, then the skipped-round
   adoption); then ``comm_report`` for diloco and gossip under a crash,
   a rejoin and a twice-lost payload beside the fault-free report (an
   empty schedule gives the fault-free report);
6e. GRPO at nanochat-d20's full width and depth (vocab 512): 16
   arithmetic prompts x G 8 sampled requests of 6 tokens, 4 iterations
   of ``GRPOTrainer.rollout_and_step`` (fused AdamW, the reference
   example's optimizer; reward 1 when the first sampled token lies in a
   set of 128 ids), then its first iteration again under torch.profiler: the set's probability at the prompts' last position
   rises; the second run's rollouts and parameters equal the first's
   bit for bit; iteration 1's rollouts of 2 prompts equal a fresh
   ``Engine``'s on the updated parameters; the rollouts launch the norms and paged decode, the
   update the training kernels, and nothing else; at depth 2 one update
   on injected completions against the CPU (phase 3's gates); per
   iteration rollout and update seconds, sampled tokens/s and peak
   memory, and the profiled iteration's device busy share;
7. time each kernel, its plain version and one PyTorch library call on
   the same inputs (CUDA events, L2 flushed before each launch) beside
   the least time the card could take
   (bound; the flash kernels' and the SSD's operations at the tensor
   cores' rate for their operand type, with two roofs beside it: the
   split-TF32 design ceiling, TC_TF32_PRODUCTS TF32 products per f32
   product, and the 67 TFLOP/s f32 roof); the SSD also at the scoring
   shape (``SSD_TIMING_SHAPES``); the flash rows also at the pipeline's
   shape (``PIPELINE_FLASH_SHAPE``) and qwen1.5-0.5b's step's
   (``QWEN_FLASH_SHAPE``), paged decode and verify also at phase 4b's
   (KV, G, D) (``ARCH_PAGED_CASES``); the norms at every
   shape of ``NORM_SHAPES`` (the backward, plain and residual, each with
   its own bound, at two), beside ``floor_ms``, the same timing of an
   empty kernel; then paged verify and the ring decode at a full cache
   and at these shapes for each chunk size of ``CHUNK_SWEEP``.

Logs each phase's seconds.  Prints the card's name and power limit, then
a ``{"kernels": [...]}`` line, then ``{"ok": true, "device": {...}}`` as
the last line.  Exits nonzero, with no result, when CUDA is unavailable
or any phase fails.

``--norm-timing`` and ``--ssd-timing`` build only rmsnorm.cu or ssd.cu
and print one JSON line of those kernels' phase-7 timings beside
``floor_ms``: run this script beside two checkouts' ``src/`` in one call
(parent, change, change, parent) to compare them on one card.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM (NVIDIA data sheet): HBM bandwidth and dense peaks by type
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float32": 67e12, "bfloat16": 989e12, "tf32": 495e12,
                  "fp8_e4m3": 1979e12}
# The flash and SSD kernels run their products on the tensor cores: share
# of each kernel's FLOPs by operand type (f32 data as TF32; the fp8
# forward's QK^T, half its FLOPs, on e4m3 codes), the rates of their bound
TC_OPS_BY_TYPE = {"flash_fwd": {"tf32": 1.0}, "flash_bwd": {"tf32": 1.0},
                  "flash_fwd_fp8": {"fp8_e4m3": 0.5, "tf32": 0.5},
                  "ssd": {"tf32": 1.0}}
# TF32 products per f32 product of the split these kernels chose (hi.lo +
# lo.hi + hi.hi; the fp8 QK^T one product on the codes, its P.V three):
# the design's own ceiling, reported beside the bound
TC_TF32_PRODUCTS = {"flash_fwd": 3, "flash_bwd": 3, "flash_fwd_fp8": 2,
                    "ssd": 3}
# flash attention (B, S, H, KV, D) in phase 5 and in the pipeline phase,
# where their flash launches happen
TRAIN_FLASH_SHAPE = (4, 1024, 10, 10, 128)
PIPELINE_FLASH_SHAPE = (8, 128, 10, 10, 128)
TOL = {"float32": (1e-5, 1e-4), "bfloat16": (1e-2, 1e-2)}   # (atol, rtol)
# f32 backward of flash attention: sums over up to G*S products in another
# order than the plain einsums; fused AdamW is exact (no FMA contraction)
TOL_FLASH_BWD = {"float32": (1e-4, 1e-4), "bfloat16": (2e-2, 2e-2)}
REPLACES = {
    "rmsnorm": "src/repro/kernels/rmsnorm/kernel.py:41",
    "rmsnorm_residual": "src/repro/kernels/rmsnorm/kernel.py:58",
    "paged_decode": "src/repro/kernels/decode_attention/kernel.py:468",
    "paged_verify": "src/repro/kernels/decode_attention/kernel.py:317",
    "flash_fwd": "src/repro/kernels/flash_attention/kernel.py:127",
    "fused_adamw": "src/repro/kernels/fused_adamw/kernel.py:61",
    # gradients: the TPU kernels have none; these are the forward kernels
    # whose gradient they compute (see "gradient_of")
    "flash_bwd": "src/repro/kernels/flash_attention/kernel.py:127",
    "rmsnorm_bwd": "src/repro/kernels/rmsnorm/kernel.py:41",
    "paged_decode_dequant": "src/repro/kernels/decode_attention/kernel.py:416",
    "paged_verify_dequant": "src/repro/kernels/decode_attention/kernel.py:367",
    # fp8=True variants of paged_decode / paged_verify: the TPU kernels
    # with qk_dot_fp8 (src/repro/kernels/common.py:31) inside
    "paged_decode_fp8": "src/repro/kernels/decode_attention/kernel.py:468",
    "paged_verify_fp8": "src/repro/kernels/decode_attention/kernel.py:317",
    "quantize_ef": "src/repro/kernels/quantize/kernel.py:95",
    "dequantize": "src/repro/kernels/quantize/kernel.py:126",
    "ssd": "src/repro/kernels/ssd/kernel.py:89",
    "ring_decode": "src/repro/kernels/decode_attention/kernel.py:489",
    # the fp8=True variant of flash_fwd: the TPU kernel with qk_dot_fp8
    # (src/repro/kernels/common.py:31) in its body (kernel.py:69-70)
    "flash_fwd_fp8": "src/repro/kernels/flash_attention/kernel.py:127",
}
QK_DOT_FP8 = "src/repro/kernels/common.py:31 qk_dot_fp8"
GRADIENT_OF = {
    "flash_bwd": "flash_fwd: the Pallas kernel has no VJP; the JAX package "
                 "differentiates its jnp reference",
    "rmsnorm_bwd": "rmsnorm and rmsnorm_residual: the JAX package "
                   "differentiates its jnp norms",
}
SOURCE = {
    "rmsnorm": "src/repro_torch/kernels/csrc/rmsnorm.cu",
    "rmsnorm_residual": "src/repro_torch/kernels/csrc/rmsnorm.cu",
    "paged_decode": "src/repro_torch/kernels/csrc/paged_attention.cu",
    "paged_verify": "src/repro_torch/kernels/csrc/paged_attention.cu",
    "flash_fwd": "src/repro_torch/kernels/csrc/flash_attention.cu",
    "flash_bwd": "src/repro_torch/kernels/csrc/flash_attention.cu",
    "fused_adamw": "src/repro_torch/kernels/csrc/fused_adamw.cu",
    "rmsnorm_bwd": "src/repro_torch/kernels/csrc/rmsnorm.cu",
    "paged_decode_dequant": "src/repro_torch/kernels/csrc/paged_attention.cu",
    "paged_verify_dequant": "src/repro_torch/kernels/csrc/paged_attention.cu",
    "paged_decode_fp8": "src/repro_torch/kernels/csrc/paged_attention.cu",
    "paged_verify_fp8": "src/repro_torch/kernels/csrc/paged_attention.cu",
    "quantize_ef": "src/repro_torch/kernels/csrc/quantize.cu",
    "dequantize": "src/repro_torch/kernels/csrc/quantize.cu",
    "ssd": "src/repro_torch/kernels/csrc/ssd.cu",
    "ring_decode": "src/repro_torch/kernels/csrc/ring_attention.cu",
    "flash_fwd_fp8": "src/repro_torch/kernels/csrc/flash_attention.cu",
}
WIRE_KERNELS = ("quantize_ef", "dequantize")
WIRE_TARGETS = ("int8", "fp8_e4m3", "fp8_e5m2")
W_UP = 131_072_000                     # 20 x 1280 x 5120: one stacked leaf
# kv_cache_dtype spelling -> quantize target of the pool
KV_TARGETS = {"int8": "int8", "fp8": "fp8_e4m3", "fp8_e5m2": "fp8_e5m2"}
TRAIN_KERNELS = ("rmsnorm", "rmsnorm_residual", "flash_fwd", "flash_bwd",
                 "fused_adamw", "rmsnorm_bwd")
# the SSD scan in f32: sums over Q*N and Q*P products in another order
# than the plain einsums (the chunk cumsum is shared to the bit)
TOL_SSD = {"float32": (1e-4, 1e-4), "bfloat16": (2e-2, 2e-2)}
# mamba2-1.3b's scan: (B, S, H, P, N, chunk); S 300 takes the padding
# path, S 64 runs at Q = 64, S 144 is the scoring call's (4 rows padded
# to 144 tokens: a chunk of 128 and one of 16); then ragged small shapes
# (Q 8, 32 and 37; N and P below a tile)
SSD_CASES = ((2, 512, 64, 64, 128, 128), (2, 300, 64, 64, 128, 128),
             (2, 64, 64, 64, 128, 128), (4, 144, 64, 64, 128, 128),
             (1, 37, 3, 8, 4, 8), (2, 100, 2, 16, 32, 32),
             (1, 80, 3, 8, 4, 37))
# the SSD's phase-7 shapes: the kernel row's and scoring's
SSD_TIMING_SHAPES = {"timed": SSD_CASES[0], "scoring": SSD_CASES[3]}
# the static path's ring decode at nanochat-d20's heads: (B, KV, G, S, D)
RING_CASE = (8, 10, 1, 320, 128)
# the fp8 QK^T flash forward: the training shape, G=2, S=1000, window 64
FP8_FLASH_CASES = (dict(), dict(KV=5), dict(S=1000), dict(window=64))
# the pipeline phase: nanochat-d20 at full width (vocab = the tokenizer's)
PIPELINE_METHODS = ("diloco", "hybrid")
PIPELINE_STEPS = {"base": 6, "mid": 4, "sft": 4}
# K 4, the reference example's: phase 6b measures K 4 with remat at phase
# 5's shape (4 x 1024 tokens a worker) at 58.2 GB of the card's 85.0
PIPELINE_KW = dict(arch="nanochat-d20", reduced=False, steps=PIPELINE_STEPS,
                   workers=4, per_worker_batch=8, seq_len=128,
                   fused_adamw=True, eval_after_each_stage=True)
PIPELINE_KERNELS = ("flash_fwd", "flash_bwd", "fused_adamw", "rmsnorm_bwd",
                    "rmsnorm_residual", "paged_decode")
# the evals run spec_k 0 on an f32 pool, the wire is f32, the model dense
PIPELINE_IDLE = ("paged_verify", "paged_decode_dequant",
                 "paged_verify_dequant", "paged_decode_fp8",
                 "paged_verify_fp8", "quantize_ef", "dequantize", "ssd",
                 "ring_decode", "flash_fwd_fp8")
# eval items per suite whose greedy tokens are also generated on the CPU
# (full-width decode on the host's cores is slow; agreement is printed)
CPU_GEN_ITEMS = 16
# where the main path launches the norms (f32 rows of d): a decode step's
# S*T rows of nanochat-d20 and of mamba2-1.3b, a pipeline worker's batch
# (8 x 128 tokens) and phase 5's (4 x 1024); the backward at the last two
NORM_SHAPES = {"decode": (8, 1, 1280), "mamba2_decode": (8, 1, 2048),
               "pipeline": (8, 128, 1280), "training": (4, 1024, 1280)}
NORM_BWD_SHAPES = ("training", "pipeline")


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def paged_case(torch, *, S=8, KV=10, G=1, D=128, bs=16, MB=32, T=1,
               dtype="float32", seed=0, starts=None):
    """Random q / pools and a ragged block table at the given shape.
    Slot 6 is inactive, slot 2 has an unmapped early block, slot 4 a
    mid-sequence one; blocks are shuffled physical ids.  Returns
    (q, k_pool, v_pool, tables, start, n_tok, live (S, T) bool host);
    see ``with_pool`` for pools in another dtype or quantized.
    ``starts``: the first S slots' start positions instead."""
    g = torch.Generator().manual_seed(seed)
    dt = getattr(torch, dtype)
    NB = S * MB
    cap = MB * bs
    starts = list(starts or [0, 17, 100, 255, 300, cap - 40, -1, 64])[:S]
    starts += [int(x) for x in torch.randint(0, cap - T, (S - len(starts),),
                                             generator=g)]
    n_tok = [T if s >= 0 else 0 for s in starts]
    if T > 1:
        n_tok = [min(T, 1 + (i % T)) if s >= 0 else 0
                 for i, s in enumerate(starts)]
    perm = torch.randperm(NB, generator=g)
    tables = torch.full((S, MB), -1, dtype=torch.int32)
    for s in range(S):
        if starts[s] < 0:
            continue
        nblk = (starts[s] + n_tok[s] - 1) // bs + 1
        tables[s, :nblk] = perm[s * MB:s * MB + nblk].to(torch.int32)
    tables[2, 0] = -1
    tables[4, 5] = -1
    q_shape = (S, KV, G, D) if T == 1 else (S, T, KV, G, D)
    q = torch.randn(q_shape, generator=g).to(dt)
    k_pool = torch.randn((NB, bs, KV, D), generator=g).to(dt)
    v_pool = torch.randn((NB, bs, KV, D), generator=g).to(dt)
    live = torch.zeros((S, T), dtype=torch.bool)
    for s in range(S):
        for t in range(n_tok[s]):
            pos = starts[s] + t
            live[s, t] = tables[s, pos // bs] >= 0      # own key attendable
    return (q, k_pool, v_pool, tables,
            torch.tensor(starts, dtype=torch.int32),
            torch.tensor(n_tok, dtype=torch.int32), live)


def with_pool(torch, k_pool, v_pool, pool):
    """The f32 pools of ``paged_case`` as ``pool``: a torch dtype name
    (a plain pool) or a quantize target (returns [k, v, k_scale,
    v_scale]: payloads quantized per (token, head))."""
    from repro_torch.kernels.quantize import quantize_axis
    if pool in ("float32", "bfloat16"):
        return [p.to(getattr(torch, pool)) for p in (k_pool, v_pool)]
    (kq, ks), (vq, vs) = (quantize_axis(p, dtype=pool)
                          for p in (k_pool.float(), v_pool.float()))
    return [kq, vq, ks[..., 0].contiguous(), vs[..., 0].contiguous()]


def max_err(torch, got, want, live=None, tol=None):
    """(max abs error over live rows, within the dtype's tolerance?, worst
    ratio of error to allowance): the gate is err <= atol + rtol * |want|
    elementwise (``tol``: {dtype name: (atol, rtol)}, default ``TOL``), so
    a ratio of at most 1 passes and the ratio shows the gate's headroom."""
    atol, rtol = (tol or TOL)[str(got.dtype).replace("torch.", "")]
    got, want = got.float(), want.float()
    if live is not None:
        got, want = got[live], want[live]
    if not got.numel():
        return 0.0, True, 0.0
    err = (got - want).abs()
    allow = atol + rtol * want.abs()
    return (float(err.max()), bool((err <= allow).all()),
            float((err / allow).max()))


def scalar_gate(err, atol, rtol, scale):
    """(within atol + rtol * scale?, ratio of err to that allowance): the
    gates that allow one error for a whole tensor (lse, dscale)."""
    ratio = err / (atol + rtol * scale)
    return ratio <= 1.0, ratio


def phase_kernels(torch, results):
    from repro_torch.kernels.decode_attention import (
        paged_decode_attention, paged_decode_attention_plain,
        paged_verify_attention, paged_verify_attention_plain)
    from repro_torch.kernels.rmsnorm import (rmsnorm, rmsnorm_plain,
                                             rmsnorm_residual,
                                             rmsnorm_residual_plain)
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(1)
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        for rows in (8, 40):
            x = (torch.randn((rows, 1280), generator=g) * 2).to(dt).to(dev)
            r = torch.randn((rows, 1280), generator=g).to(dt).to(dev)
            sc = (1 + 0.1 * torch.randn(1280, generator=g)).to(dev)
            results.append(("rmsnorm", dtype, (rows, 1280),
                            *max_err(torch, rmsnorm(x, sc),
                                     rmsnorm_plain(x, sc))))
            (o, h), (o2, h2) = (rmsnorm_residual(x, r, sc),
                                rmsnorm_residual_plain(x, r, sc))
            e1, ok1, r1 = max_err(torch, o, o2)
            e2, ok2, r2 = max_err(torch, h, h2)
            results.append(("rmsnorm_residual", dtype, (rows, 1280),
                            max(e1, e2), ok1 and ok2, max(r1, r2)))
        cases = [dict(), dict(KV=5, G=2), dict(window=64)]
        for case in cases:
            case = dict(case)
            window = case.pop("window", 0)
            for T in (1, 5):
                q, kp, vp, tab, start, ntok, live = paged_case(
                    torch, T=T, dtype=dtype, seed=T + 10 * len(case), **case)
                q, kp, vp, tab, start, ntok = (t.to(dev) for t in
                                               (q, kp, vp, tab, start, ntok))
                if T == 1:
                    got = paged_decode_attention(q, kp, vp, tab, start,
                                                 window=window)
                    want = paged_decode_attention_plain(q, kp, vp, tab,
                                                        start, window)
                    mask = live[:, 0].to(dev)
                    name = "paged_decode"
                else:
                    got = paged_verify_attention(q, kp, vp, tab, start, ntok,
                                                 window=window)
                    want = paged_verify_attention_plain(q, kp, vp, tab, start,
                                                        ntok, window)
                    mask = live.to(dev)
                    name = "paged_verify"
                torch.cuda.synchronize()
                results.append((name, dtype, tuple(q.shape) + (
                    f"window={window}",), *max_err(torch, got, want, mask)))


def phase_quant_kernels(torch, results):
    """The quantized-pool (dequant-on-load) kernels for int8, fp8_e4m3 and
    fp8_e5m2 pools, the fp8 QK^T kernels on f32 and bf16 pools, and the
    plain kernels on a bf16 pool under f32 queries, each against its
    plain version at the paged shapes of ``phase_kernels`` (G 1 and 2, T 1
    and 5, window 0 and 64), f32 and bf16 queries."""
    from repro_torch.kernels import decode_attention as da
    dev = torch.device("cuda")
    variants = [("dequant", t) for t in ("int8", "fp8_e4m3", "fp8_e5m2")]
    variants += [("fp8", "float32"), ("fp8", "bfloat16"),
                 ("plain", "bfloat16")]
    for dtype in ("float32", "bfloat16"):
        for kind, pool in variants:
            if dtype == "bfloat16" and pool == "float32":
                continue       # an f32 pool under bf16 queries: not a path
            for case in (dict(), dict(KV=5, G=2), dict(window=64)):
                case = dict(case)
                window = case.pop("window", 0)
                for T in (1, 5):
                    q, kp, vp, tab, start, ntok, live = paged_case(
                        torch, T=T, dtype=dtype, seed=T + 7 * len(case),
                        **case)
                    kv = [t.to(dev) for t in with_pool(torch, kp, vp, pool)]
                    q, tab, start, ntok = (t.to(dev) for t in
                                           (q, tab, start, ntok))
                    idx = (start,) if T == 1 else (start, ntok)
                    step = "decode" if T == 1 else "verify"
                    fn = getattr(da, f"paged_{step}_attention"
                                 + ("_dequant" if kind == "dequant" else ""))
                    plain = getattr(da, f"paged_{step}_attention"
                                    + ("_dequant" if kind == "dequant"
                                       else "") + "_plain")
                    args = (q, *kv, tab, *idx)
                    if kind == "fp8":
                        got = fn(*args, window=window, fp8=True)
                        want = plain(*args, window, True)
                    else:
                        got = fn(*args, window=window)
                        want = plain(*args, window)
                    torch.cuda.synchronize()
                    mask = (live[:, 0] if T == 1 else live).to(dev)
                    name = f"paged_{step}" + ("" if kind == "plain"
                                              else f"_{kind}")
                    results.append((name, dtype, tuple(q.shape) + (
                        f"pool={pool}", f"window={window}"),
                        *max_err(torch, got, want, mask)))


# verify ranges straddling the split kernels' chunk boundaries (64 and 256
# at CHUNK_KEYS 64; 190 -> 194 at 192), one slot at the cache's end
SPLIT_STARTS = (62, 17, 100, 252, 300, 507, -1, 190)
SPLIT_POOLS = (("plain", "float32"), ("plain", "bfloat16"),
               ("dequant", "int8"), ("dequant", "fp8_e4m3"),
               ("dequant", "fp8_e5m2"), ("fp8", "float32"))


def phase_split_invariants(torch, results):
    """Verify row t equals decode at start + t, bit for bit (torch.equal),
    at nanochat-d20's paged shapes (S 8, KV x G = 10, D 128, bs 16, MB 32:
    a cache of 8 chunks) with verify ranges straddling chunk boundaries,
    unmapped blocks and an inactive slot: f32 queries on f32, bf16, int8,
    fp8_e4m3 and fp8_e5m2 pools and with the fp8 QK^T, G 1 and 2, window
    0 and 64; bf16 queries on the bf16 pool.  The error column is the
    largest difference (0 when equal)."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels.decode_attention.ops import split_chunks
    dev = torch.device("cuda")
    check(split_chunks(32, 16)[1] >= 3, "the cache must span 3 chunks")
    cases = [("float32", kind, pool) for kind, pool in SPLIT_POOLS]
    cases.append(("bfloat16", "plain", "bfloat16"))
    for dtype, kind, pool in cases:
        for G in (1, 2):
            for window in (0, 64):
                q, kp, vp, tab, start, ntok, _ = paged_case(
                    torch, T=5, KV=10 // G, G=G, dtype=dtype, seed=G + window,
                    starts=SPLIT_STARTS)
                kv = [t.to(dev) for t in with_pool(torch, kp, vp, pool)]
                q, tab, start, ntok = (t.to(dev) for t in
                                       (q, tab, start, ntok))
                sfx = "_dequant" if kind == "dequant" else ""
                kw = dict(window=window, **({"fp8": True} if kind == "fp8"
                                            else {}))
                got = getattr(da, f"paged_verify_attention{sfx}")(
                    q, *kv, tab, start, ntok, **kw)
                err, equal = 0.0, True
                for t in range(q.shape[1]):
                    q_pos = torch.where((t < ntok) & (start >= 0), start + t,
                                        -1).to(torch.int32)
                    one = getattr(da, f"paged_decode_attention{sfx}")(
                        q[:, t].contiguous(), *kv, tab, q_pos, **kw)
                    equal &= torch.equal(got[:, t], one)
                    err = max(err, float((got[:, t].float() - one.float())
                                         .abs().max()))
                torch.cuda.synchronize()
                results.append(("verify_eq_decode", dtype, tuple(q.shape) + (
                    f"pool={pool}{'+fp8' if kind == 'fp8' else ''}",
                    f"window={window}"), err, equal, None))


def report_checks(results):
    """Logs each check: (name, dtype, shape, max abs error, ok, worst ratio
    of error to the tolerance's allowance, None for a bit-for-bit check)."""
    for name, dtype, shape, err, ok, ratio in results:
        gate = "bits" if ratio is None else f"{ratio:.3f}"
        log(f"  {name:17s} {dtype:9s} {str(shape):40s} max_abs_err={err:.3e}"
            f" gate_ratio={gate} {'ok' if ok else 'FAIL'}")
    check(all(r[4] for r in results), "a kernel disagrees with its plain "
          "version")


def flash_inputs(torch, *, B=4, S=1024, H=10, KV=10, D=128, dtype="float32",
                 seed=0):
    """Seeded q, do (B, S, H, D) and k, v (B, S, KV, D) on the card."""
    g = torch.Generator().manual_seed(seed)
    dt = getattr(torch, dtype)
    q, do = (torch.randn((B, S, H, D), generator=g).to(dt).cuda()
             for _ in range(2))
    k, v = (torch.randn((B, S, KV, D), generator=g).to(dt).cuda()
            for _ in range(2))
    return q, k, v, do


def check_flash(torch, results, dtype, window=None, **shape):
    """Flash forward (o and lse) and backward (against autograd through
    the plain forward) at ``shape`` (``flash_inputs``' keywords) against
    their plain versions; appends one check of each to ``results``."""
    from repro_torch.kernels.flash_attention import (flash_attention_plain,
                                                     flash_bwd, flash_fwd)
    q, k, v, do = flash_inputs(torch, dtype=dtype, seed=len(results),
                               **shape)
    o, lse = flash_fwd(q, k, v, window=window)
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    o_ref, lse_ref = flash_attention_plain(*leaves, True, window)
    want = torch.autograd.grad(o_ref, leaves, do)
    got = flash_bwd(q, k, v, o, lse, do, window=window)
    torch.cuda.synchronize()
    e_o, ok_o, r_o = max_err(torch, o, o_ref.detach())
    e_l = float((lse - lse_ref.detach()).abs().max())
    ok_l, r_l = scalar_gate(e_l, 1e-4, 1e-5,
                            float(lse_ref.detach().abs().max()))
    tag = (tuple(q.shape) + (f"KV={k.shape[2]}",)
           + ((f"window={window}",) if window else ()))
    results.append(("flash_fwd", dtype, tag, max(e_o, e_l), ok_o and ok_l,
                    max(r_o, r_l)))
    errs = [max_err(torch, a, b, tol=TOL_FLASH_BWD)
            for a, b in zip(got, want)]
    results.append(("flash_bwd", dtype, tag, max(e for e, _, _ in errs),
                    all(k for _, k, _ in errs), max(r for _, _, r in errs)))


def phase_train_kernels(torch, results):
    """The training slice's kernels against their plain versions: flash
    forward (o and lse) and backward (against autograd through the plain
    forward), fused AdamW (bit for bit) and the RMSNorm backward (against
    autograd of the plain norms)."""
    from repro_torch.kernels.fused_adamw import (fused_adamw_plain,
                                                 fused_adamw_update)
    from repro_torch.kernels.rmsnorm import (rmsnorm_bwd, rmsnorm_plain,
                                             rmsnorm_residual_plain)
    for dtype in ("float32", "bfloat16"):
        for case in (dict(), dict(KV=5), dict(S=1000), dict(window=256)):
            check_flash(torch, results, dtype, **case)
    g = torch.Generator().manual_seed(2)
    for n, gdt in ((65536 * 1280, "float32"), (65536 * 1280, "bfloat16"),
                   (1_000_003, "float32")):
        p = torch.randn(n, generator=g).cuda()
        gr = torch.randn(n, generator=g).to(getattr(torch, gdt)).cuda()
        m = (0.1 * torch.randn(n, generator=g)).cuda()
        v = torch.rand(n, generator=g).cuda()
        t = torch.tensor(3.0, device="cuda")
        scal = (torch.tensor(1e-3, device="cuda"), 1 - 0.9 ** t,
                1 - 0.95 ** t)
        kw = dict(b1=0.9, b2=0.95, eps=1e-10, wd=0.01)
        got = fused_adamw_update(p, gr, m, v, *scal, **kw)
        want = fused_adamw_plain(p, gr, m, v, *scal, **kw)
        torch.cuda.synchronize()
        err = max(float((a - b).abs().max()) for a, b in zip(got, want))
        results.append(("fused_adamw", gdt, (n,), err, err == 0.0, None))
        del p, gr, m, v, got, want
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        x, r, dy, dh = (torch.randn((4, 1024, 1280), generator=g).to(dt)
                        .cuda() for _ in range(4))
        sc = (1 + 0.1 * torch.randn(1280, generator=g)).cuda()
        for residual in (False, True):
            leaves = [t.clone().requires_grad_() for t in
                      ((x, r, sc) if residual else (x, sc))]
            if residual:
                want = torch.autograd.grad(rmsnorm_residual_plain(*leaves),
                                           leaves, (dy, dh))
                got = rmsnorm_bwd(dy, x, sc, residual=r, dh=dh)
            else:
                want = torch.autograd.grad(rmsnorm_plain(*leaves), leaves,
                                           dy)
                got = rmsnorm_bwd(dy, x, sc)
            torch.cuda.synchronize()
            e_x, ok_x, r_x = max_err(torch, got[0], want[0])
            # dscale: f32 sums over 4096 rows in another order
            e_s = float((got[1] - want[-1]).abs().max())
            ok_s, r_s = scalar_gate(e_s, 1e-3, 1e-4,
                                    float(want[-1].abs().max()))
            results.append(("rmsnorm_bwd", dtype,
                            (4, 1024, 1280, "residual" if residual
                             else "plain"), max(e_x, e_s), ok_x and ok_s,
                            max(r_x, r_s)))


def phase_fp8_flash_kernels(torch, results):
    """The fp8 QK^T flash forward (o and lse) against its plain version
    (quantize-dequantize the rows of q and k, then the exact attention)
    at ``FP8_FLASH_CASES``, causal, in float32 and bfloat16; its output
    must differ from the exact kernel's by more than 1e-3, so the narrow
    path is live.  In bf16 the plain version rounds the dequantized rows
    to bf16 (the JAX oracle does) and the kernel keeps them in f32 (the
    Pallas kernel does), so the lse is held to the bf16 tolerance."""
    from repro_torch.kernels.flash_attention import (
        flash_attention_fp8_plain, flash_fwd)
    for dtype in ("float32", "bfloat16"):
        for case in FP8_FLASH_CASES:
            case = dict(case)
            window = case.pop("window", None)
            q, k, v, _ = flash_inputs(torch, dtype=dtype,
                                      seed=100 + len(results), **case)
            o, lse = flash_fwd(q, k, v, window=window, fp8=True)
            o_ref, lse_ref = flash_attention_fp8_plain(q, k, v, True, window)
            exact, _ = flash_fwd(q, k, v, window=window)
            torch.cuda.synchronize()
            e_o, ok_o, r_o = max_err(torch, o, o_ref)
            e_l = float((lse - lse_ref).abs().max())
            atol, rtol = ((1e-4, 1e-5) if dtype == "float32"
                          else TOL["bfloat16"])
            ok_l, r_l = scalar_gate(e_l, atol, rtol,
                                    float(lse_ref.abs().max()))
            live = float((o.float() - exact.float()).abs().max())
            tag = (tuple(q.shape) + (f"KV={k.shape[2]}",)
                   + ((f"window={window}",) if window else ())
                   + (f"vs_exact={live:.2e}",))
            results.append(("flash_fwd_fp8", dtype, tag, max(e_o, e_l),
                            ok_o and ok_l and live > 1e-3, max(r_o, r_l)))
            del q, k, v, o, lse, o_ref, lse_ref, exact


def phase_flash_determinism(torch, results):
    """flash_fwd and flash_bwd at the training shape give the same bits on
    a second call with the same inputs, f32 and bf16: no atomics, so the
    pipeline's checkpoint reloads and the card-vs-CPU steps see one
    answer."""
    from repro_torch.kernels.flash_attention import flash_bwd, flash_fwd
    for dtype in ("float32", "bfloat16"):
        q, k, v, do = flash_inputs(torch, dtype=dtype, seed=7)
        first = flash_fwd(q, k, v)
        again = flash_fwd(q, k, v)
        grads = flash_bwd(q, k, v, *first, do)
        grads2 = flash_bwd(q, k, v, *first, do)
        torch.cuda.synchronize()
        tag = tuple(q.shape) + ("same bits on a second call",)
        for name, a, b in (("flash_fwd", first, again),
                           ("flash_bwd", grads, grads2)):
            diff = max(float((x.float() - y.float()).abs().max())
                       for x, y in zip(a, b))
            results.append((name, dtype, tag, diff,
                            all(torch.equal(x, y) for x, y in zip(a, b)),
                            None))
        del q, k, v, do, first, again, grads, grads2


# the norm kernels' layouts: warp-wide rows to 2048 (1600 masks part of
# its last tile), CTA-wide above; row counts from 1 to a training batch
NORM_WIDTHS = (64, 96, 1280, 1600, 2048, 12288)
NORM_ROWS = (1, 8, 40, 300, 4096)


def phase_norm_kernels(torch, results):
    """The RMSNorm kernels at every layout: forward (both variants) and
    backward (both variants; dscale within 1e-3 + 1e-4 of its largest
    column, as a sum over the rows in another order) against the plain
    versions, f32 and bf16, at each width of ``NORM_WIDTHS`` over the row
    counts of ``NORM_ROWS`` (to 300 at d 12288); a row's bits independent
    of the launch (40 rows at once, as 8-row slices and one by one: the
    forward's outputs and the backward's dx, bit for bit); the backward's
    dx and dscale the same bits on a second call; widths the layout does
    not take refused with ValueError."""
    from repro_torch.kernels.rmsnorm import (rmsnorm, rmsnorm_bwd,
                                             rmsnorm_bwd_plain, rmsnorm_plain,
                                             rmsnorm_residual,
                                             rmsnorm_residual_plain)

    def inputs(rows, d, dt, seed):
        g = torch.Generator().manual_seed(seed)
        t = [torch.randn((rows, d), generator=g).to(dt).cuda()
             for _ in range(4)]
        return t + [(1 + 0.1 * torch.randn(d, generator=g)).cuda()]

    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        for d in NORM_WIDTHS:
            row_counts = NORM_ROWS[:4] if d > 2048 else NORM_ROWS
            worst = {}
            for rows in row_counts:
                x, r, dy, dh, sc = inputs(rows, d, dt, rows + d)
                got = {"rmsnorm": [(rmsnorm(x, sc), rmsnorm_plain(x, sc))],
                       "rmsnorm_residual": list(zip(
                           rmsnorm_residual(x, r, sc),
                           rmsnorm_residual_plain(x, r, sc)))}
                for res in (None, r):
                    kw = {} if res is None else dict(residual=r, dh=dh)
                    (gx, gs), (wx, ws) = (
                        rmsnorm_bwd(dy, x, sc, **kw),
                        rmsnorm_bwd_plain(dy, x, sc, 1e-5, res,
                                          None if res is None else dh))
                    torch.cuda.synchronize()
                    e_s = float((gs - ws).abs().max())
                    ok_s, r_s = scalar_gate(e_s, 1e-3, 1e-4,
                                            float(ws.abs().max()))
                    e_x, ok_x, r_x = max_err(torch, gx, wx)
                    w = worst.setdefault("rmsnorm_bwd", [0.0, True, 0.0])
                    w[:] = [max(w[0], e_x, e_s), w[1] and ok_x and ok_s,
                            max(w[2], r_x, r_s)]
                torch.cuda.synchronize()
                for name, pairs in got.items():
                    for a, b in pairs:
                        e, ok, ratio = max_err(torch, a, b)
                        w = worst.setdefault(name, [0.0, True, 0.0])
                        w[:] = [max(w[0], e), w[1] and ok, max(w[2], ratio)]
            tag = (f"d={d}", "rows " + "/".join(map(str, row_counts)))
            for name, (e, ok, ratio) in worst.items():
                results.append((name, dtype, tag, e, ok, ratio))
        for d in (96, 1280, 2048, 12288):
            x, r, dy, dh, sc = inputs(40, d, dt, d)

            def run(a, b):
                o, h = rmsnorm_residual(x[a:b], r[a:b], sc)
                return (rmsnorm(x[a:b], sc), o, h,
                        rmsnorm_bwd(dy[a:b], x[a:b], sc)[0],
                        rmsnorm_bwd(dy[a:b], x[a:b], sc, residual=r[a:b],
                                    dh=dh[a:b])[0])

            whole = run(0, 40)
            for step in (8, 1):
                parts = [run(a, a + step) for a in range(0, 40, step)]
                torch.cuda.synchronize()
                diff, equal = 0.0, True
                for k, a in enumerate(whole):
                    b = torch.cat([p[k] for p in parts])
                    diff = max(diff, float((a.float() - b.float()).abs()
                                           .max()))
                    equal = equal and torch.equal(a, b)
                results.append(("norm_rows_independent", dtype, (
                    f"d={d}", f"40 rows vs {40 // step} launches of {step}"),
                    diff, equal, None))
        x, r, dy, dh, sc = inputs(4096, 1280, dt, 3)
        for kw in ({}, dict(residual=r, dh=dh)):
            first, again = (rmsnorm_bwd(dy, x, sc, **kw) for _ in range(2))
            torch.cuda.synchronize()
            diff = max(float((a.float() - b.float()).abs().max())
                       for a, b in zip(first, again))
            results.append(("rmsnorm_bwd", dtype, (
                4096, 1280, "residual" if kw else "plain",
                "same bits on a second call"), diff,
                all(torch.equal(a, b) for a, b in zip(first, again)), None))
    for d in (1284, 12296):
        x = torch.ones((2, d), device="cuda")
        sc = torch.ones(d, device="cuda")
        for name, call in (("rmsnorm", lambda: rmsnorm(x, sc)),
                           ("rmsnorm_residual",
                            lambda: rmsnorm_residual(x, x, sc)),
                           ("rmsnorm_bwd", lambda: rmsnorm_bwd(x, x, sc))):
            try:
                call()
                refused = False
            except ValueError:
                refused = True
            results.append((name, "float32", (f"d={d}", "refused"), 0.0,
                            refused, None))


def code_bits(torch, q):
    """A payload's codes as comparable integers (fp8 as its bytes)."""
    return q if q.dtype == torch.int8 else q.view(torch.uint8)


def phase_wire_kernels(torch, results):
    """quantize_ef and dequantize against their plain versions on the
    card, bit for bit (codes, residual, scales, dequantized values), for
    each target: the w_up leaf of two workers with a residual, an odd
    (1, 1280) row, a scalar leaf, and per-tile scales (tile 256) on a
    ragged (2, 1280 * 100 + 7) leaf.  The recorded error is the largest
    absolute difference of the f32 outputs (0 when bit for bit)."""
    from repro_torch.kernels.quantize import (dequantize, dequantize_plain,
                                              quantize_ef, quantize_ef_plain)
    g = torch.Generator().manual_seed(4)
    cases = (((2, W_UP), 0, True), ((1, 1280), 0, True), ((), 0, True),
             ((2, 1280 * 100 + 7), 256, True))
    for target in WIRE_TARGETS:
        for shape, tile, residual in cases:
            x = (torch.randn(shape, generator=g) * 1e-2).cuda()
            r = ((torch.randn(shape, generator=g) * 1e-5).cuda() if residual
                 else None)
            got = quantize_ef(x, r, dtype=target, tile=tile)
            want = quantize_ef_plain(x, r, dtype=target, tile=tile)
            dq = dequantize(got[0], got[2], tile=tile)
            dq_plain = dequantize_plain(want[0], want[2], tile=tile)
            torch.cuda.synchronize()
            same = (torch.equal(code_bits(torch, got[0]),
                                code_bits(torch, want[0]))
                    and torch.equal(got[1], want[1])
                    and torch.equal(got[2], want[2])
                    and torch.equal(dq, dq_plain))
            err = max(float((a - b).abs().max()) if a.numel() else 0.0
                      for a, b in ((got[1], want[1]), (got[2], want[2]),
                                   (dq, dq_plain)))
            tag = tuple(shape) + (target, f"tile={tile}")
            results.append(("quantize_ef", "float32", tag, err, same, None))
            results.append(("dequantize", "float32", tag, err, same, None))
            del x, r, got, want, dq, dq_plain


def ssd_case(torch, B, S, H, P, N, seed=0):
    """Seeded SSD inputs on the card, distributed as the JAX package's
    kernel tests draw them: x, Bm, Cm normal, dt = softplus(normal),
    A = -exp(U[0, 1)), D = 1."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((B, S, H, P), generator=g)
    dt = torch.nn.functional.softplus(torch.randn((B, S, H), generator=g))
    A = -torch.exp(torch.rand((H,), generator=g))
    Bm = torch.randn((B, S, N), generator=g)
    Cm = torch.randn((B, S, N), generator=g)
    return [t.cuda() for t in (x, dt, A, Bm, Cm, torch.ones(H))]


def ring_case(torch, B, KV, G, S, D, dtype="float32", seed=0):
    """A wrapped ring on the card: row b's last query at q_pos, slots
    holding positions counting down from q_pos - 1 around the ring over
    the first 3/4 of the slots, the rest empty (-1); the last row's query
    sits at -1 (a left-pad token: no live key).  Returns (q, k, v, pos,
    q_pos, live rows (B,) bool)."""
    g = torch.Generator().manual_seed(seed)
    dt = getattr(torch, dtype)
    q = torch.randn((B, KV, G, D), generator=g).to(dt)
    k = torch.randn((B, KV, S, D), generator=g).to(dt)
    v = torch.randn((B, KV, S, D), generator=g).to(dt)
    fill = 3 * S // 4
    base = torch.randint(fill, fill + 100, (B, 1), generator=g)
    j = torch.arange(S)[None, :]
    pos = torch.where(j < fill, (base - 1 - j) % (base + 1),
                      torch.full_like(j, -1)).to(torch.int32)
    q_pos = base[:, 0].to(torch.int32)
    q_pos[-1] = -1
    live = torch.ones(B, dtype=torch.bool)
    live[-1] = False
    return [t.cuda() for t in (q, k, v, pos, q_pos, live)]


def phase_static_kernels(torch, results):
    """The SSD scan at mamba2-1.3b's shapes (S 512; S 300, the padding
    path; S 64, Q 64) and the ring decode at (B 8, KV 10, G 1, S 320,
    D 128) with window 0 and 64 over a wrapped ring with empty slots
    (the row whose query sits at -1 excluded), plus the split kernel's
    edges: a chunk of dead slots, a window starting mid-chunk, S 200 (not
    a multiple of the chunk); against their plain versions, f32 and
    bf16."""
    from repro_torch.kernels.decode_attention import (decode_attention,
                                                      decode_attention_plain)
    from repro_torch.kernels.ssd import ssd, ssd_chunked
    for dtype in ("float32", "bfloat16"):
        for B, S, H, P, N, chunk in SSD_CASES:
            args = ssd_case(torch, B, S, H, P, N, seed=S)
            args[0] = args[0].to(getattr(torch, dtype))
            y, h = ssd(*args, chunk=chunk)
            yp, hp = ssd_chunked(*args, chunk=chunk)
            torch.cuda.synchronize()
            e1, ok1, r1 = max_err(torch, y, yp, tol=TOL_SSD)
            e2, ok2, r2 = max_err(torch, h, hp, tol=TOL_SSD)
            tag = (B, S, H, P, N, f"Q={min(chunk, S)}")
            results.append(("ssd", dtype, tag, max(e1, e2), ok1 and ok2,
                            max(r1, r2)))
            if (B, S, H, P, N, chunk) in SSD_TIMING_SHAPES.values():
                y2, h2 = ssd(*args, chunk=chunk)
                torch.cuda.synchronize()
                diff = max(float((y2.float() - y.float()).abs().max()),
                           float((h2 - h).abs().max()))
                results.append(("ssd", dtype, tag + (
                    "same bits on a second call",), diff,
                    torch.equal(y, y2) and torch.equal(h, h2), None))
        B, KV, G, S, D = RING_CASE
        for window, edge in ((0, ""), (64, ""), (0, "dead-chunk"),
                             (40, "mid-chunk"), (0, "S=200")):
            Sr = 200 if edge == "S=200" else S
            q, k, v, pos, q_pos, live = ring_case(torch, B, KV, G, Sr, D,
                                                  dtype=dtype, seed=window)
            if edge == "dead-chunk":            # row 0: slots 64-127 dead
                pos[0, 64:128] = -1
            if edge == "mid-chunk":             # the window starts mid-chunk
                pos[1] = torch.roll(pos[1], 90)
            got = decode_attention(q, k, v, pos, q_pos, window=window)
            want = decode_attention_plain(q, k, v, pos, q_pos, window)
            torch.cuda.synchronize()
            err, ok, ratio = max_err(torch, got, want, live)
            ok = ok and bool((got[~live] == 0).all())
            results.append(("ring_decode", dtype, tuple(q.shape) + (
                f"S={Sr}", f"window={window}") + ((edge,) if edge else ()),
                err, ok, ratio))


# ---------------------------------------------------------------------------
# Phase 3: full-width step on the card vs the CPU
# ---------------------------------------------------------------------------

def phase_step_vs_cpu(torch):
    from repro_torch.configs import NANOCHAT_D20
    from repro_torch.models import (decode_step_paged, init_paged_cache,
                                    init_params, verify_step_paged)
    from repro_torch.models.transformer import flatten, unflatten
    cfg = NANOCHAT_D20.with_(num_layers=2)
    params = init_params(cfg, seed=0, device="cpu")
    params_d = unflatten({k: v.cuda() for k, v in flatten(params).items()})
    g = torch.Generator().manual_seed(3)
    S, bs, MB, T = 8, 16, 32, 5
    _, _, _, tab, start, ntok, live = paged_case(torch, T=T, S=S, seed=5)
    worst = {}
    for kind in ("decode", "verify"):
        pool = init_paged_cache(cfg, S * MB, bs)
        for buf in pool.values():
            buf.normal_(generator=g)
        pool_d = {k: v.cuda() for k, v in pool.items()}
        if kind == "decode":
            batch = {"token": torch.randint(0, cfg.vocab_size, (S, 1),
                                            generator=g, dtype=torch.int32),
                     "position": start.clone(), "block_table": tab}
            step, rows = decode_step_paged, live[:, :1]
        else:
            t = torch.arange(T)[None, :]
            ok = (start[:, None] >= 0) & (t < ntok[:, None])
            batch = {"tokens": torch.randint(0, cfg.vocab_size, (S, T),
                                             generator=g, dtype=torch.int32),
                     "positions": torch.where(ok, start[:, None] + t,
                                              -1).to(torch.int32),
                     "block_table": tab}
            step, rows = verify_step_paged, live
        batch_d = {k: v.cuda() for k, v in batch.items()}
        want, pool = step(params, pool, batch, cfg)
        got, pool_d = step(params_d, pool_d, batch_d, cfg)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), f"{kind}: non-finite logits")
        e_logit = float((got.cpu() - want)[rows].abs().max())
        e_pool = max(float((pool_d[k].cpu() - pool[k]).abs().max())
                     for k in ("k", "v"))
        worst[kind] = (e_logit, e_pool)
        log(f"  {kind}_step_paged d20 width, depth 2: logits max_abs_err="
            f"{e_logit:.3e} (atol 2e-3), pool max_abs_err={e_pool:.3e} "
            f"(atol 1e-4)")
        check(e_logit <= 2e-3 and e_pool <= 1e-4,
              f"{kind} step on the card disagrees with the CPU")
    return worst


def phase_static_step_vs_cpu(torch):
    """The static path at full width and depth 2, card against CPU, same
    params and tokens: mamba2-1.3b's ``forward_lm`` over 2 rows of 200
    tokens (the SSD kernel at Q 128 with padding; logits within 2e-3),
    and for mamba2-1.3b and nanochat-d20 a 12-token static prefill (row 0
    with 3 left-pad tokens at position -1) plus one ``decode_step_lm``:
    the last logits within 2e-3, the final SSM state and conv ring (or
    the ring K/V of live slots, positions equal) within 1e-4 of their
    max."""
    from repro_torch.configs import MAMBA2_13B, NANOCHAT_D20
    from repro_torch.kernels import launches, reset_launches
    from repro_torch.models import (decode_step_lm, forward_lm,
                                    init_decode_cache, init_params)
    from repro_torch.models.transformer import flatten, unflatten
    out = {}
    for base in (MAMBA2_13B, NANOCHAT_D20):
        cfg = base.with_(num_layers=2)
        params = init_params(cfg, seed=0, device="cpu")
        params_d = unflatten({k: v.cuda() for k, v in flatten(params).items()})
        g = torch.Generator().manual_seed(4)
        rec = {}
        if cfg.arch_type == "ssm":
            toks = torch.randint(0, cfg.vocab_size, (2, 200), generator=g,
                                 dtype=torch.int32)
            with torch.no_grad():
                want, _ = forward_lm(params, {"tokens": toks}, cfg)
                reset_launches()
                got, _ = forward_lm(params_d, {"tokens": toks.cuda()}, cfg)
            torch.cuda.synchronize()
            check(launches["ssd"] == cfg.num_layers,
                  f"{cfg.name}: forward_lm launched ssd {launches['ssd']} "
                  f"times, not once per layer")
            check(bool(torch.isfinite(got).all()), "non-finite logits")
            rec["forward_logits"] = float((got.cpu() - want).abs().max())
            del got, want
        B, T = 3, 12
        lens = torch.tensor([9, 12, 12])
        toks = torch.randint(0, cfg.vocab_size, (B, T + 1), generator=g,
                             dtype=torch.int32)
        caches = [init_decode_cache(cfg, B, T + 1),
                  init_decode_cache(cfg, B, T + 1, device="cuda")]
        with torch.no_grad():
            for t in range(T + 1):
                pos = (t - (T - lens)).clamp(min=-1).to(torch.int32)
                want, caches[0] = decode_step_lm(params, caches[0], {
                    "token": toks[:, t:t + 1], "position": pos}, cfg)
                got, caches[1] = decode_step_lm(params_d, caches[1], {
                    "token": toks[:, t:t + 1].cuda(),
                    "position": pos.cuda()}, cfg)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), "non-finite logits")
        rec["decode_logits"] = float((got.cpu() - want).abs().max())
        sub = caches[0]["mamba" if cfg.arch_type == "ssm" else "attn"]
        sub_d = caches[1]["mamba" if cfg.arch_type == "ssm" else "attn"]
        for key in (("conv", "ssm") if cfg.arch_type == "ssm" else ("k", "v")):
            ref, got_c = sub[key], sub_d[key].cpu()
            if key in ("k", "v"):
                # slots of left-pad tokens (position -1) are masked; from
                # layer 2 on they hold garbage that differs by design (a
                # row with no live key: zeros on the card, the mean of V
                # in the plain version)
                live = (sub["pos"] >= 0)[:, :, None, :, None]
                ref, got_c = ref * live, got_c * live
                check(torch.equal(sub["pos"], sub_d["pos"].cpu())
                      and sub["idx"] == sub_d["idx"],
                      f"{cfg.name}: ring positions differ")
            rec[f"cache_{key}_rel"] = float(
                (got_c - ref).abs().max() / ref.abs().max())
        log(f"  {cfg.name} width, depth 2, static path: "
            + ", ".join(f"{k} {v:.3e}" for k, v in rec.items())
            + " (logits atol 2e-3, caches 1e-4 of their max)")
        check(all(v <= 2e-3 for k, v in rec.items() if "logits" in k)
              and all(v <= 1e-4 for k, v in rec.items() if "cache" in k),
              f"{cfg.name}: the static path on the card disagrees with "
              f"the CPU")
        out[cfg.name] = rec
    return out


def fp8_quanta(torch, codes, scale, ref_codes, ref_scale):
    """Largest |dequant - ref dequant| of two fp8_e4m3 pools, in quanta:
    units of the e4m3 spacing at the larger of the two codes (2^(e-3)
    for a normal code of exponent e, 2^-9 below 2^-6), times the
    reference row's scale."""
    a, b = codes.float(), ref_codes.float()
    diff = (a * scale[..., None] - b * ref_scale[..., None]).abs()
    mag = torch.maximum(a.abs(), b.abs()).clamp(min=2.0 ** -6)
    step = torch.exp2(torch.floor(torch.log2(mag)) - 3)
    return float((diff / (step * ref_scale[..., None])).max())


def phase_quant_step_vs_cpu(torch):
    """One decode and one verify step of nanochat-d20 at full width and
    depth 2 on an fp8 pool, card against CPU, same params, batch and
    pool: logits within 2e-3, and the pool after the step (payload times
    scale) within one fp8 quantum of the CPU's: card and CPU GEMMs sum
    in another order, which may put a fresh K/V value on the other side
    of a rounding boundary."""
    from repro_torch.configs import NANOCHAT_D20
    from repro_torch.kernels.quantize import quantize_axis
    from repro_torch.models import (decode_step_paged, init_paged_cache,
                                    init_params, verify_step_paged)
    from repro_torch.models.transformer import flatten, unflatten
    cfg = NANOCHAT_D20.with_(num_layers=2, kv_cache_dtype="fp8")
    params = init_params(cfg, seed=0, device="cpu")
    params_d = unflatten({k: v.cuda() for k, v in flatten(params).items()})
    g = torch.Generator().manual_seed(13)
    S, bs, MB, T = 8, 16, 32, 5
    _, _, _, tab, start, ntok, live = paged_case(torch, T=T, S=S, seed=6)
    worst = {}
    for kind in ("decode", "verify"):
        pool = init_paged_cache(cfg, S * MB, bs)
        for name in ("k", "v"):
            pool[name], sc = quantize_axis(
                torch.randn(pool[name].shape, generator=g), dtype="fp8_e4m3")
            pool[f"{name}_scale"] = sc[..., 0].contiguous()
        pool_d = {k: v.cuda() for k, v in pool.items()}
        if kind == "decode":
            batch = {"token": torch.randint(0, cfg.vocab_size, (S, 1),
                                            generator=g, dtype=torch.int32),
                     "position": start.clone(), "block_table": tab}
            step, rows = decode_step_paged, live[:, :1]
        else:
            t = torch.arange(T)[None, :]
            ok = (start[:, None] >= 0) & (t < ntok[:, None])
            batch = {"tokens": torch.randint(0, cfg.vocab_size, (S, T),
                                             generator=g, dtype=torch.int32),
                     "positions": torch.where(ok, start[:, None] + t,
                                              -1).to(torch.int32),
                     "block_table": tab}
            step, rows = verify_step_paged, live
        batch_d = {k: v.cuda() for k, v in batch.items()}
        want, pool = step(params, pool, batch, cfg)
        got, pool_d = step(params_d, pool_d, batch_d, cfg)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()),
              f"fp8 pool {kind}: non-finite logits")
        e_logit = float((got.cpu() - want)[rows].abs().max())
        quanta = max(fp8_quanta(torch, pool_d[k].cpu(),
                                pool_d[f"{k}_scale"].cpu(), pool[k],
                                pool[f"{k}_scale"]) for k in ("k", "v"))
        e_scale = max(float(((pool_d[k].cpu() - pool[k]).abs()
                             / pool[k].abs().clamp(min=1e-30)).max())
                      for k in ("k_scale", "v_scale"))
        flips = sum(int((pool_d[k].cpu().view(torch.uint8)
                         != pool[k].view(torch.uint8)).sum())
                    for k in ("k", "v"))
        worst[kind] = (e_logit, quanta, e_scale, flips)
        log(f"  {kind}_step_paged d20 width, depth 2, fp8 pool: logits "
            f"max_abs_err={e_logit:.3e} (atol 2e-3), pool within "
            f"{quanta:.3f} quanta (tol 1), scales rel {e_scale:.2e}, "
            f"{flips} payload codes differ")
        check(e_logit <= 2e-3 and quanta <= 1.0 + 1e-3,
              f"fp8-pool {kind} step on the card disagrees with the CPU")
    return worst


def rel_err(torch, got, want):
    """max |got - want| / max |want| over one tensor (got on any device)."""
    want = want.float()
    return float((got.float().cpu() - want).abs().max()
                 / want.abs().max().clamp(min=1e-30))


def loss_grads_vs_cpu(torch, loss_fn, params, params_d, batch):
    """``loss_fn(tree, batch)`` and its gradients on the CPU (``params``,
    a flat dict) and on the card (``params_d``, the same numbers): the
    loss's relative error and the worst leaf's max error over its max
    |g|.  Returns (loss on the CPU, loss on the card, gradient rel err,
    the CPU's gradients)."""
    from repro_torch.models.transformer import unflatten
    out = {}
    for dev, p in (("cpu", params), ("cuda", params_d)):
        leaves = {k: v.clone().requires_grad_() for k, v in p.items()}
        loss, _ = loss_fn(unflatten(leaves), {k: v.to(dev) for k, v in
                                              batch.items()})
        grads = torch.autograd.grad(loss, list(leaves.values()))
        out[dev] = (float(loss.detach()), dict(zip(leaves, grads)))
        del leaves, grads
    (l_cpu, g_cpu), (l_gpu, g_gpu) = out["cpu"], out["cuda"]
    e_grad = max(rel_err(torch, g_gpu[k], g_cpu[k]) for k in g_cpu)
    return l_cpu, l_gpu, e_grad, g_cpu


def train_step_vs_cpu(torch, cfg, B, S, seed):
    """One training step of ``cfg`` on the card and on the CPU, same
    parameters (seed 0) and batch (B x S tokens from ``seed``): the loss
    (rtol 1e-5) and every gradient (max error over max |g| <= 1e-4, f32
    GEMMs sum in another order); one ``nanochat_optimizer`` update with
    fused AdamW from the CPU's gradients on both (<= 1e-4 of each leaf's
    max |update|: Newton-Schulz's products in another order).  Returns
    (errors, CPU params, card params, tokens (2, B, S + 1) of which the
    batch is the first, the optimizer config)."""
    from repro_torch.configs import OptimizerConfig
    from repro_torch.models import init_params, lm_loss
    from repro_torch.models.transformer import flatten
    params = flatten(init_params(cfg, seed=0, device="cpu"))
    params_d = {k: v.cuda() for k, v in params.items()}
    g = torch.Generator().manual_seed(seed)
    toks = torch.randint(0, cfg.vocab_size, (2, B, S + 1), generator=g,
                         dtype=torch.int32)
    batch = {"tokens": toks[0, :, :-1], "labels": toks[0, :, 1:]}
    l_cpu, l_gpu, e_grad, g_cpu = loss_grads_vs_cpu(
        torch, lambda p, b: lm_loss(p, b, cfg), params, params_d, batch)
    e_loss = abs(l_gpu - l_cpu) / abs(l_cpu)
    log(f"  {cfg.name} width, depth {cfg.num_layers}, B {B} x S {S}: loss "
        f"{l_gpu:.6f} (rel {e_loss:.2e} of the CPU's, tol 1e-5); worst "
        f"gradient leaf {e_grad:.2e} of its max (tol 1e-4)")
    check(e_loss <= 1e-5 and e_grad <= 1e-4,
          f"{cfg.name}: training step on the card disagrees with the CPU")
    opt_cfg = OptimizerConfig(total_steps=10, warmup_steps=2,
                              fused_adamw=True)
    e_upd = update_vs_cpu(torch, opt_cfg, params, params_d, g_cpu, cfg.name)
    return ({"loss_rel": e_loss, "grad_rel": e_grad, "update_rel": e_upd},
            params, params_d, toks, opt_cfg)


def update_vs_cpu(torch, opt_cfg, params, params_d, g_cpu, what):
    """One ``nanochat_optimizer(opt_cfg)`` update at step 1 from the CPU's
    gradients on both devices: the worst leaf's max error over its max
    |update| (gate 1e-4: Newton-Schulz's products in another order)."""
    from repro_torch.optim import nanochat_optimizer
    opt = nanochat_optimizer(opt_cfg)
    upd = {}
    for dev, p in (("cpu", params), ("cuda", params_d)):
        step = torch.tensor(1, dtype=torch.int32, device=dev)
        u, _ = opt.update({k: v.to(dev) for k, v in g_cpu.items()},
                          opt.init(p), p, step)
        upd[dev] = u
    e_upd = max(rel_err(torch, upd["cuda"][k], upd["cpu"][k])
                for k in upd["cpu"])
    log(f"  nanochat_optimizer update (fused AdamW), same grads: worst "
        f"leaf {e_upd:.2e} of its max (tol 1e-4)")
    check(e_upd <= 1e-4, f"{what}: optimizer update on the card disagrees "
          f"with the CPU")
    return e_upd


def phase_train_step_vs_cpu(torch):
    """``train_step_vs_cpu`` of nanochat-d20 at full width and depth 2
    (B 2, S 256), then one DiLoCo outer round, K=2 and H=1, through
    ``DistTrainer`` (losses rtol 1e-5, global params <= 1e-4 of each
    leaf's max)."""
    from repro_torch.configs import NANOCHAT_D20, DiLoCoConfig
    from repro_torch.core import DistTrainer, make_strategy
    from repro_torch.models import lm_loss
    cfg = NANOCHAT_D20.with_(num_layers=2)
    errs, params, params_d, toks, opt_cfg = train_step_vs_cpu(
        torch, cfg, 2, 256, 11)
    dcfg = DiLoCoConfig(num_workers=2, h_inner_steps=1)
    # worker w trains on sequence 0 of toks[w]: (K 2, B 1, S 256)
    data = lambda s: {"tokens": toks[:, :1, :-1], "labels": toks[:, :1, 1:]}
    runs = {}
    for dev, p in (("cpu", params), ("cuda", params_d)):
        dt = DistTrainer(lambda pp, b: lm_loss(pp, b, cfg), opt_cfg, dcfg,
                         make_strategy(dcfg))
        state, hist = dt.run(dt.init(p), data, 1)
        runs[dev] = (hist, state.global_params)
        del state
    (h_cpu, p_cpu), (h_gpu, p_gpu) = runs["cpu"], runs["cuda"]
    e_l = abs(h_gpu["loss"][0] - h_cpu["loss"][0]) / abs(h_cpu["loss"][0])
    e_p = max(rel_err(torch, p_gpu[k], p_cpu[k]) for k in p_cpu)
    log(f"  DiLoCo round K=2 H=1: loss rel {e_l:.2e} (tol 1e-5), global "
        f"params worst leaf {e_p:.2e} of its max (tol 1e-4), syncs "
        f"{h_gpu['sync_steps']}")
    check(e_l <= 1e-5 and e_p <= 1e-4 and h_gpu["sync_steps"] == [0],
          "DiLoCo outer round on the card disagrees with the CPU")
    return dict(errs, diloco_loss_rel=e_l, diloco_param_rel=e_p)


def code_steps(torch, a, b):
    """|code distance| between two payloads of one target, elementwise:
    int8 values, or fp8 bytes read as sign-magnitude ordinals (adjacent
    fp8 values of one sign are adjacent bytes)."""
    if a.dtype == torch.int8:
        return (a.int() - b.int()).abs()
    ord_ = lambda q: ((q.view(torch.uint8).int() & 0x7F)
                      * (1 - 2 * (q.view(torch.uint8).int() >> 7)))
    return (ord_(a) - ord_(b)).abs()


def grid_pos(torch, y, codec):
    """Continuous position of ``y`` (in scale units) on a wire's code
    grid: y itself for int8; for fp8 (e4m3) the ordinal of the code
    grid, linear between codes (8 subnormal steps of 2^-9, then 8 steps a
    binade), signed.  At every code it equals the code's ordinal."""
    if codec == "int8":
        return y
    m = y.abs()
    e = torch.floor(torch.log2(m.clamp(min=2.0 ** -6)))
    pos = torch.where(m < 2.0 ** -6, m * 2.0 ** 9,
                      8 + 8 * (e + 6) + (m / torch.exp2(e) - 1) * 8)
    return torch.sign(y) * pos


# share of the codes that may lie more than one step apart between the
# card's and the CPU's own inner steps (measured on an H100: 7.5e-8 int8,
# 4.2e-6 fp8)
FAR_CODES_MAX = 1e-5


def phase_wire_round_vs_cpu(torch):
    """One DiLoCo outer round of nanochat-d20 at full width and depth 2
    (K=2, H=1, worker w on sequence 0 of its batch, B 1 x S 256) with an
    int8 and an fp8 wire, card against CPU from the same parameters.

    (a) The inner step runs on each device; the K deltas of each leaf are
    encoded on both.  The two devices' inner steps differ in the last
    bits (GEMM order, Newton-Schulz), and AdamW's first step turns a
    gradient g into the update -lr * g / (|g| + eps), which moves by up to
    a quarter of lr per unit relative change of g where |g| is near eps
    (1e-10); so a delta may differ by more than a code step.  The gates:
    no code further from the CPU's than the two deltas' difference in
    code steps plus one (the rounding), at most FAR_CODES_MAX of the codes
    more than one step apart, and each scale within its two amaxes'
    relative difference plus 1e-6.  Printed: the codes that differ, those
    more than one step apart in AdamW and in Muon leaves, and how many of
    the AdamW ones have a CPU gradient within 100x of eps (|g| from the
    first step's second moment, sqrt(v / (1 - beta2))).
    (b) The CPU's post-inner-step state, copied to the card, takes the
    outer round on both devices: the new anchor, momentum and residual
    (the residual is e - q * scale, so it carries every code and scale)
    must be equal bit for bit (the round is elementwise f32 arithmetic in
    one order, and the kernels equal the plain versions)."""
    import dataclasses
    from repro_torch.configs import (NANOCHAT_D20, DiLoCoConfig,
                                     OptimizerConfig)
    from repro_torch.core import DistTrainer, make_strategy, outer_opt
    from repro_torch.core.transport import make_codec
    from repro_torch.models import init_params, lm_loss
    from repro_torch.models.transformer import flatten
    from repro_torch.optim.combined import partition_label
    cfg = NANOCHAT_D20.with_(num_layers=2)
    params = flatten(init_params(cfg, seed=0, device="cpu"))
    g = torch.Generator().manual_seed(17)
    toks = torch.randint(0, cfg.vocab_size, (2, 1, 257), generator=g,
                         dtype=torch.int32)
    batch = {"tokens": toks[:, :, :-1], "labels": toks[:, :, 1:]}
    opt_cfg = OptimizerConfig(total_steps=10, warmup_steps=2,
                              fused_adamw=True)
    dcfg = DiLoCoConfig(num_workers=2, h_inner_steps=1)
    inner = {}
    for dev in ("cpu", "cuda"):
        dt = DistTrainer(lambda pp, b: lm_loss(pp, b, cfg), opt_cfg, dcfg,
                         make_strategy(dcfg))
        eng = dt.engine()
        state = dt.init({k: v.to(dev) for k, v in params.items()})
        state, _ = eng.inner_step(state, {k: v.to(dev) for k, v in
                                          batch.items()})
        inner[dev] = (eng, state)
    cpu_eng, cpu_state = inner["cpu"]

    def on(dev, st):
        """A copy of ``st`` on ``dev`` (every tensor, so rounds start
        equal and leave the original untouched)."""
        cp = lambda d: {k: v.to(dev, copy=True) for k, v in d.items()}
        return st._replace(
            global_params=cp(st.global_params),
            worker_params=[cp(w) for w in st.worker_params],
            outer=st.outer._replace(v=cp(st.outer.v),
                                    t=st.outer.t.to(dev, copy=True)))

    out = {}
    for codec in ("int8", "fp8"):
        # (a) each device's own inner step
        flips, beyond, n, worst, e_scale = 0, 0, 0, 0, 0.0
        far = {"adamw": 0, "muon": 0}
        near_eps, far_by_leaf = 0, {}
        for k in params:
            enc = {}
            for dev, (eng, state) in inner.items():
                d = outer_opt.stack_delta([w[k] for w in
                                           state.worker_params],
                                          state.global_params[k])
                payload, _ = make_codec(codec).encode({k: d})
                enc[dev] = (d.cpu(), payload.data[k].cpu(),
                            payload.scales[k].cpu())
            (dc, qc, sc), (dg, qg, sg) = enc["cpu"], enc["cuda"]
            dist = code_steps(torch, qg, qc)
            # the deltas' own distance in code steps, per element: the
            # codes' ordinals follow G(e / scale), exactly at each code
            # and within half a step between them (round to nearest), so
            # two codes lie at most |G(y_card) - G(y_cpu)| + 1 apart
            y = lambda d, sc_: d / sc_.reshape((-1,) + (1,) * (d.dim() - 1))
            gap = (grid_pos(torch, y(dg, sg), codec)
                   - grid_pos(torch, y(dc, sc), codec)).abs()
            allowed = gap + 1 + 1e-3
            check(bool((dist <= allowed).all()),
                  f"{codec} wire, {k}: a card code is further from the "
                  f"CPU's than the deltas' distance on the code grid + 1 "
                  f"(worst excess {float((dist - allowed).max()):.3f})")
            amax = lambda t: t.abs().reshape(t.shape[0], -1).amax(1)
            a_rel = ((amax(dg) - amax(dc)).abs() / amax(dc)).reshape(
                sc.shape)
            s_rel = (sg - sc).abs() / sc
            check(bool((s_rel <= a_rel + 1e-6).all()),
                  f"{codec} wire, {k}: scales further apart than the "
                  f"amaxes")
            flips += int((dist > 0).sum())
            far_k = dist > 1
            nf = int(far_k.sum())
            beyond += nf
            if nf:
                label = partition_label(k, params[k])
                far[label] += nf
                far_by_leaf[k] = nf
                if label == "adamw":
                    b2, eps = opt_cfg.adam_betas[1], opt_cfg.adam_eps
                    g_abs = torch.stack([o["adamw"]["v"][k] for o in
                                         cpu_state.inner_opt]).div(
                                             1 - b2).sqrt()
                    near = (g_abs >= eps / 100) & (g_abs <= eps * 100)
                    near_eps += int((far_k & near).sum())
            worst = max(worst, int(dist.max()))
            n += dist.numel()
            e_scale = max(e_scale, float(s_rel.max()))
        # (b) the same post-inner-step state on both devices
        wcfg = dataclasses.replace(dcfg, delta_dtype=codec)
        e = dataclasses.replace(cpu_eng, cfg=wcfg)
        res0 = e.init_residual(cpu_state.global_params)
        gen = torch.Generator().manual_seed(3)
        for r in res0.values():
            r.normal_(generator=gen).mul_(1e-6)
        synced = {}
        for dev in ("cpu", "cuda"):
            st, res = e.outer_step_ef(on(dev, cpu_state), {
                k: v.to(dev, copy=True) for k, v in res0.items()})
            synced[dev] = (st, res)
        (s_c, r_c), (s_g, r_g) = synced["cpu"], synced["cuda"]
        same = all(torch.equal(b.cpu(), a) for x, y in (
            (s_c.global_params, s_g.global_params), (s_c.outer.v,
                                                      s_g.outer.v),
            (r_c, r_g)) for a, b in ((x[k], y[k]) for k in x))
        out[codec] = {"codes_differing": flips, "codes": n,
                      "codes_beyond_one_step": beyond,
                      "beyond_by_partition": far,
                      "beyond_adamw_g_within_100x_eps": near_eps,
                      "beyond_by_leaf": far_by_leaf,
                      "max_code_steps": worst, "scale_rel": e_scale,
                      "same_state_round_bitwise": same}
        log(f"  DiLoCo round K=2 H=1, {codec} wire: own inner steps: "
            f"{flips} of {n} codes differ, {beyond} by more than one step "
            f"(at most {worst}; each within its deltas' difference + 1; "
            f"{far['adamw']} in AdamW leaves, {near_eps} of them with "
            f"|g| within 100x of eps, {far['muon']} in Muon leaves; by "
            f"leaf {far_by_leaf}), scales rel {e_scale:.2e} (within the "
            f"amaxes' + 1e-6); same state on both: anchor, momentum and "
            f"residual {'bit for bit' if same else 'DIFFER'}")
        check(beyond <= FAR_CODES_MAX * n,
              f"{codec} wire: {beyond} of {n} codes more than one step "
              f"apart, above {FAR_CODES_MAX:g} of the codes")
        check(same, f"{codec}-wire outer round from one state differs "
              f"between the card and the CPU")
        del synced
    return out


# ---------------------------------------------------------------------------
# Phase 4: the main path
# ---------------------------------------------------------------------------

PROMPT_LENS = (5, 16, 64, 128, 33, 200, 9, 300)
PAGED = ("paged_decode", "paged_verify", "paged_decode_dequant",
         "paged_verify_dequant", "paged_decode_fp8", "paged_verify_fp8")
ENGINE_PATHS = (
    # path-name prefix, config change, the attention kernel of spec_k 0
    # and of spec_k 4 (every other paged kernel must stay at 0 launches)
    ("", {}, "paged_decode", "paged_verify"),
    ("int8_", dict(kv_cache_dtype="int8"), "paged_decode_dequant",
     "paged_verify_dequant"),
    ("fp8_", dict(kv_cache_dtype="fp8"), "paged_decode_dequant",
     "paged_verify_dequant"),
    ("fp8_e5m2_", dict(kv_cache_dtype="fp8_e5m2"), "paged_decode_dequant",
     "paged_verify_dequant"),
    ("fp8_matmul_", dict(fp8_matmul=True), "paged_decode_fp8",
     "paged_verify_fp8"),
)
CAPACITY_POOL_BYTES = 131_072_000      # 40 f32 blocks of nanochat-d20


def phase_engine(torch):
    """Each path of ``ENGINE_PATHS`` (f32 pool, int8 / fp8 / fp8_e5m2
    pools, fp8 QK^T on an f32 pool) at spec_k 0 and 4 over the 8 ragged
    requests (max_new 32 on the f32 pool, 16 on the others): greedy tokens equal between the two, every kernel of the
    run launched, the other paged kernels not; token agreement of each
    path's stream with the f32 one (printed, not gated: a quantized pool
    is lossy); then an f32 and an fp8-pool spec_k=0 run under
    torch.profiler."""
    from repro_torch import Engine
    from repro_torch.configs import NANOCHAT_D20
    from repro_torch.models import init_params
    cfg = NANOCHAT_D20
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    log(f"  nanochat-d20 params: {cfg.param_count() / 1e6:.1f} M on the card "
        f"({time.perf_counter() - t0:.1f} s to init)")
    g = torch.Generator().manual_seed(7)
    prompts = [torch.randint(1, cfg.vocab_size, (n,), generator=g).tolist()
               for n in PROMPT_LENS]
    # 16 = 3 chunks of spec_k+1 = 5 and one token left, fed as a decode
    # round whose carry ends an n-gram seen earlier in the prompt: the
    # drafter proposes prompt[6:10], so spec_k=4 verifies real drafts and
    # rolls back the rejected ones
    prompts[1][13:16] = prompts[1][3:6]
    runs, f32_tokens = {}, None
    for prefix, change, k0_kernel, k4_kernel in ENGINE_PATHS:
        pcfg = cfg.with_(**change)
        out = {}
        for spec_k, attn_kernel in ((0, k0_kernel), (4, k4_kernel)):
            name = f"{prefix}spec_k{spec_k}"
            out[spec_k], runs[name] = engine_run(
                torch, pcfg, params, prompts, spec_k,
                ("rmsnorm", "rmsnorm_residual", attn_kernel), name,
                max_new=16 if prefix else 32)
        check(out[0] == out[4], f"{prefix or 'f32 '}greedy tokens differ "
              f"between spec_k=0 and 4")
        if f32_tokens is None:
            f32_tokens = out[0]
        agree = token_agreement(out[0], f32_tokens)
        for spec_k in (0, 4):
            runs[f"{prefix}spec_k{spec_k}"]["agreement_with_f32"] = agree
        log(f"  {prefix or 'f32 '}greedy tokens equal between spec_k=0 and "
            f"4; agreement with the f32 stream {agree:.4f} (not gated)")
    profile = {}
    for label, change in (("f32", {}), ("fp8_pool",
                                         dict(kv_cache_dtype="fp8"))):
        eng = Engine(cfg.with_(**change), params, max_len=512, num_slots=8,
                     block_size=16, device="cuda")
        profile[label] = profile_engine(torch, eng, prompts)
        del eng
        torch.cuda.empty_cache()
    runs["capacity"] = phase_capacity(torch, cfg, params)
    return runs, profile


def engine_run(torch, cfg, params, prompts, spec_k, need, name,
               max_new=32):
    """One ``Engine`` run of ``prompts`` after a warm-up request, launch
    counts reset just before it; gates the outputs' shape and the launch
    counts.  Returns (tokens, run record)."""
    from repro_torch import Engine, Request
    from repro_torch.kernels import KERNELS, launches, reset_launches
    eng = Engine(cfg, params, max_len=512, num_slots=8, block_size=16,
                 spec_k=spec_k, device="cuda")
    eng.run([Request(rid=99, prompt=[1, 2, 3], max_new=2)])   # warm-up
    reqs = [Request(rid=i, prompt=p, max_new=max_new)
            for i, p in enumerate(prompts)]
    torch.cuda.synchronize()
    reset_launches()
    stats = eng.run(reqs)
    torch.cuda.synchronize()
    counts = {k: launches[k] for k in KERNELS}
    tps = stats["generated"] / stats["wall"]
    kv = eng.kv_report()
    run = {"launches": counts, "wall_s": stats["wall"],
           "generated": stats["generated"],
           "step_calls": stats["step_calls"], "tokens_per_s": tps,
           "drafted": stats.get("drafted", 0),
           "accepted": stats.get("accepted", 0),
           "kv_pool_dtype": kv["kv_pool_dtype"],
           "bytes_per_block": kv["bytes_per_block"]}
    log(f"  Engine {name} (pool {kv['kv_pool_dtype']}, fp8_matmul "
        f"{cfg.fp8_matmul}): {stats['generated']} tokens in "
        f"{stats['wall']:.3f} s ({tps:.1f} tokens/s), {stats['step_calls']} "
        f"step calls, drafted {stats.get('drafted', 0)} accepted "
        f"{stats.get('accepted', 0)}, launches "
        f"{ {k: v for k, v in counts.items() if v} }")
    for r in reqs:
        check(len(r.tokens) == max_new and all(0 <= t < cfg.vocab_size
                                               for t in r.tokens),
              f"{name}: request {r.rid} output malformed")
    for k in need:
        check(counts[k] > 0, f"{name}: kernel {k} never launched on the "
              f"main path")
    for k in PAGED:
        if k not in need:
            check(counts[k] == 0, f"{name}: kernel {k} launched off its "
                  f"path")
    if spec_k:
        check(stats["drafted"] > 0, f"{name}: spec_k={spec_k} drafted no "
              f"token")
    tokens = [r.tokens for r in reqs]
    del eng
    torch.cuda.empty_cache()
    return tokens, run


def token_agreement(tokens, ref) -> float:
    """Share of positions where two greedy streams emit the same token."""
    pairs = [(a, b) for ra, rb in zip(tokens, ref) for a, b in zip(ra, rb)]
    return sum(a == b for a, b in pairs) / len(pairs)


def phase_capacity(torch, cfg, params, n_req=16, prompt_len=200,
                   max_new=8):
    """Admitted requests at one byte budget: an f32-pool and an fp8-pool
    engine, each sized by ``pool_bytes`` = 40 f32 blocks' worth, 16
    slots, serving 16 requests of 200 prompt tokens and max_new 8
    (spec_k 4: prefill runs 5 tokens per forward).  Records num_blocks
    and the peak of concurrently admitted requests."""
    from repro_torch import Engine, Request
    g = torch.Generator().manual_seed(9)
    prompts = [torch.randint(1, cfg.vocab_size, (prompt_len,),
                             generator=g).tolist() for _ in range(n_req)]
    out = {}
    for kv in ("", "fp8"):
        eng = Engine(cfg.with_(kv_cache_dtype=kv), params, max_len=256,
                     num_slots=16, block_size=16, spec_k=4,
                     pool_bytes=CAPACITY_POOL_BYTES, device="cuda")
        reqs = [Request(rid=i, prompt=p, max_new=max_new)
                for i, p in enumerate(prompts)]
        stats = eng.run(reqs)
        torch.cuda.synchronize()
        check(all(len(r.tokens) == max_new for r in reqs),
              f"capacity run ({kv or 'f32'}): a request did not finish")
        rep = eng.kv_report()
        out[kv or "f32"] = {
            "num_blocks": eng.num_blocks, "pool_bytes": rep["pool_bytes"],
            "bytes_per_block": eng.bytes_per_block,
            "peak_admitted": stats["peak_admitted"], "wall_s": stats["wall"],
            "tokens_per_s": stats["generated"] / stats["wall"]}
        del eng
        torch.cuda.empty_cache()
    f, q = out["f32"], out["fp8"]
    log(f"  capacity at pool_bytes {CAPACITY_POOL_BYTES}: f32 "
        f"{f['num_blocks']} blocks ({f['bytes_per_block']} B each), peak "
        f"{f['peak_admitted']} admitted, {f['wall_s']:.2f} s; fp8 "
        f"{q['num_blocks']} blocks ({q['bytes_per_block']} B each), peak "
        f"{q['peak_admitted']} admitted, {q['wall_s']:.2f} s "
        f"({n_req} requests of {prompt_len} prompt tokens, max_new "
        f"{max_new}, 16 slots)")
    return out


def profile_engine(torch, eng, prompts, max_new=8):
    """Device time by kernel over one spec_k=0 run of the same prompts
    (torch.profiler, device activity only), and the device's busy share
    of the run's wall time.  Tracing slows the host a little, so the busy
    share is a lower bound."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import Request
    reqs = [Request(rid=100 + i, prompt=p, max_new=max_new)
            for i, p in enumerate(prompts)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        stats = eng.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name = device_time_by_kernel(torch, prof)
    busy_s = sum(by_name.values()) / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    out = {"wall_s": wall, "device_busy_s": busy_s,
           "busy_share": busy_s / wall if wall else None,
           "token_steps": stats["step_calls"] * eng.prefill_chunk,
           "top_kernels_ms": [(k, us / 1e3) for k, us in top]}
    if not by_name:
        log("  profiler: no device time recorded (not measured)")
        return out
    log(f"  profiled spec_k=0 run, pool {eng.kv_report()['kv_pool_dtype']} "
        f"(max_new={max_new}): wall {wall:.3f} s, "
        f"device busy {busy_s:.3f} s ({100 * busy_s / wall:.1f}%), "
        f"{out['token_steps']} token-steps")
    for k, ms in out["top_kernels_ms"]:
        log(f"    {ms:9.2f} ms  {100 * ms / 1e3 / busy_s:5.1f}%  {k[:90]}")
    return out


def device_time_by_kernel(torch, prof):
    """{kernel name: device microseconds} from a torch.profiler run, summed
    over its raw device events (the profiler's own grouping,
    ``key_averages``, takes about a minute for a serving run's ~1e5
    launches; a device event's self time is its duration)."""
    from torch.autograd import DeviceType
    by_name = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        by_name[e.name()] = by_name.get(e.name(), 0.0) + e.duration_ns() / 1e3
    return by_name


STATIC_FORBIDDEN = PAGED + ("flash_fwd", "flash_bwd")


def static_counts(torch):
    from repro_torch.kernels import KERNELS, launches
    torch.cuda.synchronize()
    return {k: launches[k] for k in KERNELS}


def phase_static_serving(torch):
    """The static-bucket serving path and scoring.

    mamba2-1.3b at full width and depth (48 layers, random weights from
    seed 0): ``Engine.generate`` of the 8 ragged requests of phase 4
    (greedy, max_new 16), which takes the static path (an SSM has no
    paged cache): rmsnorm kernels launched, no paged, flash or SSD
    kernel; then ``score_continuations_batch`` of 4 rows (one longer than
    128 tokens, one shorter than 64): the SSD kernel once per layer, no
    paged or flash kernel; a short static run and the scoring call under
    torch.profiler.

    nanochat-d20 at full width: the same 8 requests on an engine whose
    max_len (256) cannot hold the 300-token prompt, so ``generate`` takes
    the static path and the ring decode kernel (no paged kernel); then,
    on a batch that fits (prompts cut to 200 tokens), the share of greedy
    tokens equal between the static path and the scheduler (printed, not
    gated: cuBLAS sums GEMMs of other row counts in other orders)."""
    import numpy as np
    from repro_torch import Engine
    from repro_torch.configs import MAMBA2_13B, NANOCHAT_D20
    from repro_torch.kernels import reset_launches
    from repro_torch.models import init_params
    from repro_torch.models.transformer import flatten
    runs, max_new = {}, 16
    g = torch.Generator().manual_seed(7)
    lens = PROMPT_LENS

    cfg = MAMBA2_13B
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(v.numel() for v in flatten(params).values())
    log(f"  mamba2-1.3b params: {n_params / 1e6:.1f} M on the card "
        f"({time.perf_counter() - t0:.1f} s to init)")
    prompts = [torch.randint(1, cfg.vocab_size, (n,), generator=g).tolist()
               for n in lens]
    eng = Engine(cfg, params, device="cuda")
    check(not eng.continuous, "mamba2-1.3b engine built a paged pool")
    eng.generate([[1, 2, 3]], max_new=2)                      # warm-up
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    rows = eng.generate(prompts, max_new=max_new)
    counts = static_counts(torch)
    wall = time.perf_counter() - t0
    check(len(rows) == len(prompts) and all(
        len(r) == max_new and all(0 <= t < cfg.vocab_size for t in r)
        for r in rows), "mamba2 generate: output malformed")
    check(counts["rmsnorm"] > 0 and counts["rmsnorm_residual"] > 0,
          "mamba2 generate: the rmsnorm kernels never launched")
    check(all(counts[k] == 0 for k in STATIC_FORBIDDEN + ("ssd",
                                                          "ring_decode")),
          f"mamba2 generate launched a kernel off its path: {counts}")
    steps = max(lens) + max_new - 1
    runs["mamba2_generate"] = {
        "launches": counts, "wall_s": wall, "generated": len(rows) * max_new,
        "tokens_per_s": len(rows) * max_new / wall, "decode_steps": steps,
        "ms_per_step": 1e3 * wall / steps}
    log(f"  Engine mamba2-1.3b generate (static path, B 8, Tp "
        f"{max(lens)}, max_new {max_new}): {len(rows) * max_new} tokens in "
        f"{wall:.3f} s ({len(rows) * max_new / wall:.1f} tokens/s, "
        f"{1e3 * wall / steps:.2f} ms per decode step), launches "
        f"{ {k: v for k, v in counts.items() if v} }")

    score_rows = [(prompts[3][:120], prompts[0][:12]),     # 132 tokens
                  (prompts[2][:40], prompts[1][:8]),       # 48 tokens
                  (prompts[5][:90], prompts[6][:5]),
                  (prompts[4][:20], prompts[7][:16])]
    eng.score_continuations_batch(score_rows)                 # warm-up
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    scores = eng.score_continuations_batch(score_rows)
    counts = static_counts(torch)
    wall = time.perf_counter() - t0
    check(scores.shape == (4,) and bool(np.isfinite(scores).all())
          and bool((scores < 0).all()), f"mamba2 scores malformed: {scores}")
    check(counts["ssd"] == cfg.num_layers,
          f"mamba2 scoring launched ssd {counts['ssd']} times, not once "
          f"per layer ({cfg.num_layers})")
    check(all(counts[k] == 0 for k in STATIC_FORBIDDEN + ("ring_decode",)),
          f"mamba2 scoring launched a kernel off its path: {counts}")
    runs["mamba2_score"] = {"launches": counts, "wall_s": wall,
                            "scores": [float(x) for x in scores]}
    log(f"  mamba2-1.3b score_continuations_batch (4 rows, padded to 144 "
        f"tokens): {wall * 1e3:.1f} ms, scores {np.round(scores, 3)}, "
        f"launches { {k: v for k, v in counts.items() if v} }")
    short = [p[:32] for p in prompts]
    short_steps = max(len(p) for p in short) + 4 - 1
    runs["mamba2_profile"] = dict(profile_static(
        torch, lambda: eng.generate(short, max_new=4),
        f"static generate ({short_steps} decode steps, B {len(short)})"),
        decode_steps=short_steps)
    runs["mamba2_score_profile"] = profile_static(
        torch, lambda: eng.score_continuations_batch(score_rows),
        "score_continuations_batch (4 rows, padded to 144 tokens)")
    del eng, params
    torch.cuda.empty_cache()

    cfg = NANOCHAT_D20
    params = init_params(cfg, seed=0, device="cuda")
    prompts = [torch.randint(1, cfg.vocab_size, (n,), generator=g).tolist()
               for n in lens]
    eng = Engine(cfg, params, max_len=256, num_slots=8, block_size=16,
                 device="cuda")
    check(not eng._fits(prompts, max_new), "the d20 batch fits the pool")
    eng.generate([[1] * 300], max_new=2)                      # warm-up
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    rows = eng.generate(prompts, max_new=max_new)
    counts = static_counts(torch)
    wall = time.perf_counter() - t0
    check(all(len(r) == max_new for r in rows), "d20 static: malformed")
    check(counts["ring_decode"] == cfg.num_layers * steps,
          f"d20 static launched ring_decode {counts['ring_decode']} times, "
          f"not {cfg.num_layers} x {steps}")
    check(all(counts[k] == 0 for k in STATIC_FORBIDDEN + ("ssd",)),
          f"d20 static launched a kernel off its path: {counts}")
    runs["d20_static"] = {
        "launches": counts, "wall_s": wall, "generated": len(rows) * max_new,
        "tokens_per_s": len(rows) * max_new / wall,
        "ms_per_step": 1e3 * wall / steps}
    log(f"  Engine nanochat-d20 over capacity (max_len 256): static path, "
        f"{len(rows) * max_new} tokens in {wall:.3f} s "
        f"({len(rows) * max_new / wall:.1f} tokens/s), launches "
        f"{ {k: v for k, v in counts.items() if v} }")
    fit = [p[:200] for p in prompts]
    big = Engine(cfg, params, max_len=512, num_slots=8, block_size=16,
                 device="cuda")
    check(big._fits(fit, max_new), "the cut batch does not fit")
    sched = big.generate(fit, max_new=max_new)
    static = [list(r) for r in big.generate_ids_static(fit, max_new=max_new)]
    agree = token_agreement(static, sched)
    runs["d20_static"]["static_vs_scheduler_agreement"] = agree
    log(f"  nanochat-d20 static vs scheduler greedy tokens on a fitting "
        f"batch: {agree:.4f} agree (not gated)")
    del eng, big, params
    torch.cuda.empty_cache()
    return runs


def profile_static(torch, fn, what):
    """Device time by kernel over one call of ``fn`` on the static path (a
    generate, a scoring call; torch.profiler, device activity only) and
    the device's busy share of its wall time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name = device_time_by_kernel(torch, prof)
    busy_s = sum(by_name.values()) / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    out = {"wall_s": wall, "device_busy_s": busy_s,
           "busy_share": busy_s / wall if wall else None,
           "top_kernels_ms": [(k, us / 1e3) for k, us in top]}
    if not by_name:
        log("  profiler: no device time recorded (not measured)")
        return out
    log(f"  profiled {what}: wall {wall:.3f} s, device busy {busy_s:.3f} s "
        f"({100 * busy_s / wall:.1f}%)")
    for k, ms in out["top_kernels_ms"]:
        log(f"    {ms:9.2f} ms  {100 * ms / 1e3 / busy_s:5.1f}%  {k[:90]}")
    return out


# ---------------------------------------------------------------------------
# Phase 4b: the dense architectures besides nanochat-d20
# ---------------------------------------------------------------------------

# (arch id, layers run): full published widths, heads and vocabularies,
# f32, random weights from seed 0.  The depth is cut where the f32
# parameters at full depth exceed the card (415 / 490 / 62.5 GB at 64 /
# 88 / 32 layers) to ~25 GB; qwen1.5-0.5b runs whole (1.86 GB)
ARCH_PLANS = (("qwen1.5-0.5b", 24), ("command-r-plus-104b", 2),
              ("mistral-large-123b", 4), ("nemotron-4-15b", 8))
ARCH_MAX_NEW = 16
# the serving path's kernels: every other kernel stays at 0 launches
ARCH_KERNELS = ("rmsnorm", "rmsnorm_residual", "paged_decode",
                "paged_verify")
# the paged kernels at these configs' new (KV, G, D): qwen's 16 heads of
# 64, the 96-head configs' groups of 12 and nemotron's of 6; verify at T 5
# (R = T * G rows up to 60)
ARCH_PAGED_CASES = ((16, 1, 64), (8, 12, 128), (8, 6, 128))
# qwen1.5-0.5b's training: one DiLoCo round at full depth (K 2, H 2, 4 x
# 256 tokens a worker, fused AdamW); the flash kernels at its step's
# (B, S, H, KV, D); the depth-2 step against the CPU at B 2 x S 128
QWEN = "qwen1.5-0.5b"
QWEN_SEQ = 256
QWEN_TRAIN = dict(steps=2, workers=2, per_worker_batch=4, h=2)
QWEN_FLASH_SHAPE = (4, QWEN_SEQ, 16, 16, 64)


def phase_arch_kernels(torch, results):
    """The paged decode and verify kernels at ``ARCH_PAGED_CASES`` and the
    flash kernels at ``QWEN_FLASH_SHAPE`` (head dim 64), f32 and bf16,
    against their plain versions with phase 2's tolerances."""
    from repro_torch.kernels.decode_attention import (
        paged_decode_attention, paged_decode_attention_plain,
        paged_verify_attention, paged_verify_attention_plain)
    dev = torch.device("cuda")
    B, S, H, KV, D = QWEN_FLASH_SHAPE
    for dtype in ("float32", "bfloat16"):
        for kv, G, d in ARCH_PAGED_CASES:
            for T in (1, 5):
                q, kp, vp, tab, start, ntok, live = (
                    t.to(dev) for t in paged_case(
                        torch, KV=kv, G=G, D=d, T=T, dtype=dtype,
                        seed=100 + T + G))
                if T == 1:
                    name, mask = "paged_decode", live[:, 0]
                    got = paged_decode_attention(q, kp, vp, tab, start)
                    want = paged_decode_attention_plain(q, kp, vp, tab,
                                                        start)
                else:
                    name, mask = "paged_verify", live
                    got = paged_verify_attention(q, kp, vp, tab, start,
                                                 ntok)
                    want = paged_verify_attention_plain(q, kp, vp, tab,
                                                        start, ntok)
                torch.cuda.synchronize()
                results.append((name, dtype, tuple(q.shape),
                                *max_err(torch, got, want, mask)))
        check_flash(torch, results, dtype, B=B, S=S, H=H, KV=KV, D=D)


def phase_archs(torch, checks):
    """The dense configs of ``ARCH_PLANS`` on the card: their new kernel
    shapes (``phase_arch_kernels``), then each config's serving run
    (``arch_serving``), qwen1.5-0.5b's training (``qwen_training``), one
    config at a time with the card's memory freed between them."""
    from repro_torch.configs import get_config
    new = []
    phase_arch_kernels(torch, new)
    report_checks(new)
    checks.extend(new)
    runs = {}
    for arch, layers in ARCH_PLANS:
        cfg = get_config(arch).with_(num_layers=layers)
        runs[arch] = arch_serving(torch, cfg)
        if arch == QWEN:
            runs[arch]["train"] = qwen_training(torch, cfg)
        torch.cuda.empty_cache()
    return runs


def arch_serving(torch, cfg):
    """``cfg`` (random weights from seed 0) serves phase 4's 8 ragged
    requests (16 new tokens) through ``Engine`` with spec_k 0 and 4 on an
    f32 pool, launch counts reset just before each run; gates: finite
    logits of a forward, greedy tokens equal between spec_k 0 and 4 and
    equal to ``generate_ids_static``'s (the ring kernel's path), each run
    launching the norms and its paged kernel and no other kernel.  Logs
    tokens/s, ms a step and the config's peak memory."""
    from repro_torch import Engine
    from repro_torch.kernels import KERNELS, launches, reset_launches
    from repro_torch.models import forward_lm, init_params
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    log(f"  {cfg.name}: {cfg.num_layers} layers, d {cfg.d_model}, "
        f"{cfg.num_heads} heads over {cfg.num_kv_heads} of "
        f"{cfg.resolved_head_dim()}, d_ff {cfg.d_ff} ({cfg.mlp_activation}),"
        f" vocab {cfg.vocab_size} ({'tied' if cfg.tie_embeddings else 'untied'}"
        f"{', qkv bias' if cfg.qkv_bias else ''}): "
        f"{cfg.param_count() * 4 / 1e9:.2f} GB of f32 parameters "
        f"({time.perf_counter() - t0:.1f} s to init)")
    g = torch.Generator().manual_seed(7)
    prompts = [torch.randint(1, cfg.vocab_size, (n,), generator=g).tolist()
               for n in PROMPT_LENS]
    prompts[1][13:16] = prompts[1][3:6]       # a draft for spec_k 4
    with torch.no_grad():
        logits, _ = forward_lm(params, {"tokens": torch.tensor(
            [prompts[1]], device="cuda")}, cfg)
    check(bool(torch.isfinite(logits).all()), f"{cfg.name}: non-finite "
          f"logits")
    del logits
    out, run = {}, {"layers": cfg.num_layers,
                    "param_gb": cfg.param_count() * 4 / 1e9}
    for spec_k, attn_kernel in ((0, "paged_decode"), (4, "paged_verify")):
        name = f"{cfg.name}_spec_k{spec_k}"
        out[spec_k], rec = engine_run(
            torch, cfg, params, prompts, spec_k,
            ("rmsnorm", "rmsnorm_residual", attn_kernel), name,
            max_new=ARCH_MAX_NEW)
        off = {k: n for k, n in rec["launches"].items()
               if n and k not in ARCH_KERNELS}
        check(not off, f"{name}: kernels {off} launched off the path")
        rec["ms_per_step_call"] = 1e3 * rec["wall_s"] / rec["step_calls"]
        run[f"spec_k{spec_k}"] = rec
    check(out[0] == out[4], f"{cfg.name}: greedy tokens differ between "
          f"spec_k=0 and 4")
    eng = Engine(cfg, params, max_len=512, num_slots=8, block_size=16,
                 device="cuda")
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    static = eng.generate_ids_static(prompts, max_new=ARCH_MAX_NEW)
    wall = time.perf_counter() - t0
    counts = {k: launches[k] for k in KERNELS}
    steps = max(PROMPT_LENS) + ARCH_MAX_NEW
    run["static"] = {"launches": counts, "wall_s": wall,
                     "tokens_per_s": static.size / wall,
                     "ms_per_decode_step": 1e3 * wall / steps}
    check(static.tolist() == out[0], f"{cfg.name}: greedy tokens of the "
          f"continuous engine differ from generate_ids_static's")
    run["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    log(f"  {cfg.name}: greedy tokens equal between spec_k 0, 4 and the "
        f"static path; tokens/s {run['spec_k0']['tokens_per_s']:.1f} / "
        f"{run['spec_k4']['tokens_per_s']:.1f} / "
        f"{run['static']['tokens_per_s']:.1f} (ms a step call "
        f"{run['spec_k0']['ms_per_step_call']:.1f} / "
        f"{run['spec_k4']['ms_per_step_call']:.1f}, a static decode step "
        f"{run['static']['ms_per_decode_step']:.2f}), static launches "
        f"{ {k: v for k, v in counts.items() if v} }, peak "
        f"{run['peak_memory_gb']:.2f} GB")
    del eng, params
    return run


def qwen_training(torch, cfg):
    """qwen1.5-0.5b at full depth: one DiLoCo round through ``run_stage``
    (``QWEN_TRAIN`` on the synthetic corpus at seq_len ``QWEN_SEQ``, the
    tokenizer's ids under the config's 151,936-row vocabulary): the loss
    falls, the training kernels launch and no other; then the depth-2
    step against the CPU (``train_step_vs_cpu``, B 2 x S 128)."""
    from repro_torch.configs import DiLoCoConfig, OptimizerConfig
    from repro_torch.kernels import KERNELS, launches, reset_launches
    from repro_torch.launch.train import build_pipeline, run_stage
    from repro_torch.models import init_params
    _, _, stages, _ = build_pipeline(seq_len=QWEN_SEQ)
    opt_cfg = OptimizerConfig(total_steps=QWEN_TRAIN["steps"],
                              warmup_steps=1, learning_rate=0.02,
                              adam_lr=1e-3, fused_adamw=True)
    params = init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    final, hist = run_stage("diloco", cfg, params, stages["base"],
                            opt_cfg=opt_cfg, diloco_cfg=DiLoCoConfig(),
                            seed=0, **QWEN_TRAIN)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: launches[k] for k in KERNELS}
    tokens = (QWEN_TRAIN["workers"] * QWEN_TRAIN["per_worker_batch"]
              * QWEN_SEQ)
    run = {"launches": counts, "loss": hist["loss"],
           "sync_steps": hist["sync_steps"],
           "step_seconds": hist["step_seconds"],
           "tokens_per_s": tokens / hist["step_seconds"], "wall_s": wall,
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    log(f"  {cfg.name} DiLoCo round {QWEN_TRAIN}, seq_len {QWEN_SEQ}: "
        f"losses {[round(x, 4) for x in hist['loss']]}, syncs "
        f"{hist['sync_steps']}, step {hist['step_seconds']:.3f} s "
        f"({run['tokens_per_s']:.0f} tokens/s), peak "
        f"{run['peak_memory_gb']:.2f} GB, launches "
        f"{ {k: v for k, v in counts.items() if v} }")
    check(all(math.isfinite(x) for x in hist["loss"])
          and hist["loss"][-1] < hist["loss"][0],
          f"{cfg.name}: the loss did not fall")
    check(hist["sync_steps"] == [1], f"{cfg.name}: syncs "
          f"{hist['sync_steps']}")
    for k in KERNELS:
        check((counts[k] > 0) == (k in TRAIN_KERNELS),
              f"{cfg.name} training: kernel {k} launched {counts[k]} times")
    del params, final
    torch.cuda.empty_cache()
    run["vs_cpu"] = train_step_vs_cpu(torch, cfg.with_(num_layers=2), 2,
                                      128, 13)[0]
    return run


TRAIN_SEQ = 1024
_K2 = dict(workers=2, per_worker_batch=4)
TRAIN_PLANS = (
    # path, method, run_stage arguments, DiLoCoConfig fields, expected
    # (sync_steps, frag_syncs)
    ("diloco", "diloco", dict(steps=4, h=2, **_K2), {}, ([1, 3], [])),
    ("ddp", "ddp", dict(steps=2, h=1, **_K2), {}, ([0, 1], [])),
    ("diloco_int8", "diloco", dict(steps=4, h=2, **_K2),
     dict(delta_dtype="int8"), ([1, 3], [])),
    ("diloco_fp8", "diloco", dict(steps=4, h=2, **_K2),
     dict(delta_dtype="fp8"), ([1, 3], [])),
    ("diloco_fp8_e5m2", "diloco", dict(steps=4, h=2, **_K2),
     dict(delta_dtype="fp8_e5m2"), ([1, 3], [])),
    ("ddp_compressed_fp8", "ddp", dict(steps=2, h=1, **_K2),
     dict(grad_compress="fp8"), ([0, 1], [])),
    ("streaming_int8", "streaming", dict(steps=4, h=2, **_K2),
     dict(delta_dtype="int8", num_fragments=2),
     ([], [(0, 0), (1, 1), (2, 0), (3, 1)])),
    ("overlapped_int8", "overlapped", dict(steps=4, h=2, **_K2),
     dict(delta_dtype="int8", sync_delay=1), ([2, 3], [])),
    ("pipelined_int8", "pipelined", dict(steps=4, h=2, **_K2),
     dict(delta_dtype="int8", num_fragments=2, sync_delay=1),
     ([], [(2, 0), (3, 1)])),
)


def phase_train(torch):
    """The training main path at full nanochat-d20 through ``run_stage``,
    fused AdamW on, on the synthetic corpus at seq_len 1024: each path of
    ``TRAIN_PLANS`` (K=2 at per-worker batch 4; DDP at global batch 8).
    Launch counts and the transport's wire-byte count are reset just
    before each run."""
    from repro_torch.configs import (NANOCHAT_D20, DiLoCoConfig,
                                     OptimizerConfig)
    from repro_torch.core import transport
    from repro_torch.kernels import KERNELS, launches, reset_launches
    from repro_torch.launch.train import build_pipeline, run_stage
    from repro_torch.models import init_params
    cfg = NANOCHAT_D20
    _, tok, stages, _ = build_pipeline(seq_len=TRAIN_SEQ)
    ds = stages["base"]
    log(f"  corpus: {ds.num_tokens} tokens of a {tok.vocab_size}-token BPE, "
        f"seq_len {TRAIN_SEQ}; model {cfg.name}, {cfg.num_layers} layers, "
        f"d {cfg.d_model}, vocab {cfg.vocab_size}, float32")
    runs, profile = {}, None
    for path, method, kw, dkw, (syncs, frags) in TRAIN_PLANS:
        opt_cfg = OptimizerConfig(total_steps=kw["steps"], warmup_steps=1,
                                  learning_rate=0.02, adam_lr=1e-3,
                                  fused_adamw=True)
        dcfg = DiLoCoConfig(**dkw)
        wire = (dcfg.grad_compress if method == "ddp" else dcfg.delta_dtype)
        lossy = wire not in ("none", "float32")
        params = init_params(cfg, seed=0, device="cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        transport.reset_shipped()
        t0 = time.perf_counter()
        final, hist = run_stage(method, cfg, params, ds, opt_cfg=opt_cfg,
                                diloco_cfg=dcfg, seed=0, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {k: launches[k] for k in KERNELS}
        peak = torch.cuda.max_memory_allocated()
        k_eff = 1 if method == "ddp" and not lossy else kw["workers"]
        step_tokens = kw["workers"] * kw["per_worker_batch"] * TRAIN_SEQ
        losses = hist["loss"]
        n_syncs = len(hist["sync_steps"]) + len(hist["frag_syncs"])
        wire_bytes = sum(transport.shipped.values())
        runs[path] = {
            "method": method, "config": dkw, "launches": counts,
            "loss": losses, "sync_steps": hist["sync_steps"],
            "frag_syncs": hist["frag_syncs"],
            "step_seconds": hist["step_seconds"],
            "tokens_per_s": step_tokens / hist["step_seconds"],
            "wall_s": wall, "tokens_per_s_wall": kw["steps"] * step_tokens
            / wall, "peak_memory_gb": peak / 1e9, "workers": k_eff,
            "step_tokens": step_tokens, "wire": dict(transport.shipped),
            "wire_bytes_per_worker_per_sync":
                wire_bytes / k_eff / n_syncs if wire_bytes else None}
        log(f"  run_stage({method!r}) {path} {kw} {dkw}: losses "
            f"{[round(x, 4) for x in losses]}, syncs {hist['sync_steps']} "
            f"frag_syncs {hist['frag_syncs']}, step "
            f"{hist['step_seconds']:.3f} s "
            f"({runs[path]['tokens_per_s']:.0f} tokens/s over "
            f"{step_tokens} tokens a step), wall {wall:.2f} s, peak "
            f"{peak / 1e9:.2f} GB, wire bytes per worker per sync "
            f"{runs[path]['wire_bytes_per_worker_per_sync']} "
            f"({dict(transport.shipped)} in {n_syncs} syncs), launches "
            f"{ {k: v for k, v in counts.items() if v} }")
        check(all(math.isfinite(x) for x in losses),
              f"{path}: non-finite loss")
        check(hist["sync_steps"] == syncs and hist["frag_syncs"] == frags,
              f"{path}: sync records {hist['sync_steps']} "
              f"{hist['frag_syncs']} != {syncs} {frags}")
        check(losses[-1] < losses[0], f"{path}: the loss did not fall")
        for k in TRAIN_KERNELS + (WIRE_KERNELS if lossy else ()):
            check(counts[k] > 0, f"{path}: kernel {k} never launched on "
                  f"the main path")
        if not lossy:
            check(counts["quantize_ef"] == counts["dequantize"] == 0,
                  f"{path}: a wire kernel launched on the f32 wire")
        if path == "diloco":
            profile = profile_train_step(torch, cfg, final, ds, opt_cfg, kw)
        del params, final
        torch.cuda.empty_cache()
    for path, ms in time_outer_syncs(torch, cfg, ds).items():
        if path in runs:
            runs[path]["outer_sync_ms"] = ms
    return runs, profile


def time_outer_syncs(torch, cfg, ds, reps=3):
    """Device ms of one outer sync of each training path (CUDA events, the
    mean of ``reps``), from one K=2 nanochat-d20 state after one inner
    step.  Every sync writes the anchor into the workers, so small seeded
    noise is added to the workers before each timed sync to keep the
    deltas (and the work of the codecs) real."""
    import dataclasses
    from repro_torch.configs import DiLoCoConfig, OptimizerConfig
    from repro_torch.core import (DistTrainer, compressed_ddp_config,
                                  fragment_masks, make_strategy)
    from repro_torch.models import init_params, lm_loss
    dcfg = DiLoCoConfig(num_workers=2, h_inner_steps=2)
    dt = DistTrainer(lambda p, b: lm_loss(p, b, cfg),
                     OptimizerConfig(total_steps=4, warmup_steps=1,
                                     fused_adamw=True), dcfg,
                     make_strategy(dcfg))
    state = dt.init(init_params(cfg, seed=0, device="cuda"))
    eng = dt.engine()
    batch = {k: torch.from_numpy(v).cuda() for k, v in
             ds.worker_batches(0, 2, 4).items()}
    state, _ = eng.inner_step(state, batch)
    del batch
    frag = fragment_masks(state.global_params, 2)[0]
    g = torch.Generator(device="cuda").manual_seed(23)

    def with_wire(**kw):
        return dataclasses.replace(eng, cfg=dataclasses.replace(dcfg, **kw))

    def snap(sel):
        return lambda st: [{k: w[k][sl].clone() for k, sl in sel.items()
                            if sl is not None} for w in st.worker_params]

    whole = {k: slice(None) for k in state.global_params}
    full = (None, lambda e, st, res, _: e.outer_step_ef(st, res))
    plans = [("diloco", with_wire(), full),
             ("diloco_int8", with_wire(delta_dtype="int8"), full),
             ("diloco_fp8", with_wire(delta_dtype="fp8"), full),
             ("diloco_fp8_e5m2", with_wire(delta_dtype="fp8_e5m2"), full),
             ("ddp_compressed_fp8", dataclasses.replace(
                 eng, cfg=compressed_ddp_config(dataclasses.replace(
                     dcfg, grad_compress="fp8"))), full),
             ("streaming_int8", with_wire(delta_dtype="int8"), (
                 None, lambda e, st, res, _: e.outer_step_fragment_ef(
                     st, frag, res))),
             ("overlapped_int8", with_wire(delta_dtype="int8"), (
                 snap(whole), lambda e, st, res, sn: e.sync(
                     st, res, snapshot=sn))),
             ("pipelined_int8", with_wire(delta_dtype="int8"), (
                 snap(frag), lambda e, st, res, sn: e.sync(
                     st, res, frag=frag, snapshot=sn, fragment=0)))]
    out = {}
    for path, e, (prep, run) in plans:
        res = e.init_residual(state.global_params)
        times = []
        for _ in range(reps):
            for w in state.worker_params:
                for t in w.values():
                    t.add_(torch.randn(t.shape, generator=g, device="cuda"),
                           alpha=1e-4)
            sn = prep(state) if prep else None     # taken at capture time
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            torch.cuda.synchronize()
            a.record()
            state, res = run(e, state, res, sn)
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b))
            del sn
        out[path] = sum(times) / reps
        del res
        torch.cuda.empty_cache()
        log(f"  one outer sync, {path}: {out[path]:.2f} ms of device time "
            f"(mean of {reps})")
    del state
    torch.cuda.empty_cache()
    return out


def profile_train_step(torch, cfg, params, ds, opt_cfg, kw):
    """Device time by kernel over one DiLoCo inner step (both workers) at
    the main path's shapes, after one warm-up step, and the device's busy
    share of its wall time (torch.profiler, device activity only)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import DiLoCoConfig
    from repro_torch.core import DistTrainer, make_strategy
    from repro_torch.models import lm_loss
    dcfg = DiLoCoConfig(num_workers=kw["workers"], h_inner_steps=kw["h"])
    dt = DistTrainer(lambda p, b: lm_loss(p, b, cfg), opt_cfg, dcfg,
                     make_strategy(dcfg))
    state = dt.init(params)
    eng = dt.engine()
    batch = {k: torch.from_numpy(v).cuda() for k, v in
             ds.worker_batches(0, kw["workers"], kw["per_worker_batch"])
             .items()}
    state, _ = eng.inner_step(state, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, loss = eng.inner_step(state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name = device_time_by_kernel(torch, prof)
    busy_s = sum(by_name.values()) / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    out = {"wall_s": wall, "device_busy_s": busy_s,
           "busy_share": busy_s / wall if wall else None,
           "top_kernels_ms": [(k, us / 1e3) for k, us in top]}
    del state
    if not by_name:
        log("  profiler: no device time recorded (not measured)")
        return out
    log(f"  profiled one DiLoCo inner step (K={kw['workers']}): wall "
        f"{wall:.3f} s, device busy {busy_s:.3f} s "
        f"({100 * busy_s / wall:.1f}%)")
    for k, ms in out["top_kernels_ms"]:
        log(f"    {ms:9.2f} ms  {100 * ms / 1e3 / busy_s:5.1f}%  {k[:90]}")
    return out


# ---------------------------------------------------------------------------
# Phase 6: the three-stage pipeline with evals
# ---------------------------------------------------------------------------

def phase_pipeline(torch):
    """``run_pipeline`` (base -> mid -> SFT, evals after each stage) of
    nanochat-d20 at full width for each of ``PIPELINE_METHODS``, each from
    fresh parameters, launch counts reset just before each run.  Gates:
    finite losses, a falling base loss, the stage methods, the kernels of
    the path launched and no other, every eval value in [0, 1] and a
    finite held-out CE, and the ``{method}_final`` checkpoint reloaded
    through the port's ``load_pytree`` + ``load_config`` giving the same
    held-out CE bit for bit.  Then the hybrid run's final parameters on
    the CPU: held-out CE (rtol 1e-4) and the MC option scores (1e-3 of
    their magnitude) against the card's; greedy-token agreement of the
    first ``CPU_GEN_ITEMS`` arith / pattern items printed."""
    import shutil
    import tempfile

    from repro_torch.checkpoint import (load_config, load_pytree,
                                        params_from_numpy)
    from repro_torch.evals import heldout_metrics
    from repro_torch.kernels import KERNELS, launches, reset_launches
    from repro_torch.launch.train import build_pipeline, run_pipeline
    _, tok, stages, suites = build_pipeline(seq_len=PIPELINE_KW["seq_len"])
    heldout_kw = dict(ds=stages["base"], batches=4, batch_size=8)
    want_methods = {"diloco": ["diloco"] * 3,
                    "hybrid": ["diloco", "ddp", "ddp"]}
    out_root = ROOT / "build"
    out_root.mkdir(exist_ok=True)
    runs, final = {}, None
    for method in PIPELINE_METHODS:
        out_dir = tempfile.mkdtemp(prefix="pipeline_", dir=out_root)
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        res = run_pipeline(method, out_dir=out_dir, device="cuda",
                           **PIPELINE_KW)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {k: launches[k] for k in KERNELS}
        st = res["stages"]
        for stage, e in st.items():
            p = e["port"]
            log(f"  {method}:{stage} ({e['method']}) loss "
                f"{e['loss_first']:.4f} -> {e['loss_last']:.4f}, step "
                f"{e['step_seconds']:.4f} s, {p['tokens_per_s']:.0f} "
                f"tokens/s, peak {p['peak_memory_gb']:.2f} GB, heldout_ce "
                f"{e['core']['heldout_ce']:.6f}, tasks {e['tasks']}, eval "
                f"{p['eval_seconds']:.2f} s")
        log(f"  {method}: {wall:.2f} s, launches "
            f"{ {k: v for k, v in counts.items() if v} }")
        check([st[s]["method"] for s in ("base", "mid", "sft")]
              == want_methods[method], f"pipeline {method}: stage methods "
              f"{[e['method'] for e in st.values()]}")
        check(all(math.isfinite(x) for e in st.values()
                  for x in e["losses"] + [e["loss_last"]]),
              f"pipeline {method}: non-finite loss")
        check(st["base"]["loss_last"] < st["base"]["loss_first"],
              f"pipeline {method}: the base loss did not fall")
        for k in PIPELINE_KERNELS:
            check(counts[k] > 0, f"pipeline {method}: kernel {k} never "
                  f"launched on the main path")
        for k in PIPELINE_IDLE:
            check(counts[k] == 0, f"pipeline {method}: kernel {k} launched "
                  f"off its path")
        for e in st.values():
            check(all(0.0 <= x <= 1.0 for x in e["tasks"].values()),
                  f"pipeline {method}: an eval value outside [0, 1]")
            check(math.isfinite(e["core"]["heldout_ce"]),
                  f"pipeline {method}: non-finite heldout_ce")
        ckpt = str(Path(out_dir) / f"{method}_final")
        cfg = load_config(ckpt)
        params = params_from_numpy(load_pytree(ckpt), cfg, "cuda")
        again = heldout_metrics(cfg, params, **heldout_kw)["heldout_ce"]
        want = st["sft"]["core"]["heldout_ce"]
        log(f"  {method}_final reloaded: {cfg.name}, {cfg.num_layers} "
            f"layers, d {cfg.d_model}, vocab {cfg.vocab_size}; heldout_ce "
            f"{again!r} vs the run's {want!r}")
        check(again == want, f"pipeline {method}: the reloaded checkpoint "
              f"gives another heldout_ce")
        runs[method] = {"wall_s": wall, "launches": counts,
                        "stages": st}
        if method == "hybrid":
            final = (cfg, params)
        else:
            del params
        shutil.rmtree(out_dir, ignore_errors=True)
        torch.cuda.empty_cache()
    runs["hybrid"]["eval_profile"] = profile_evals(torch, tok, suites,
                                                   heldout_kw, *final)
    runs["hybrid"]["card_vs_cpu"] = pipeline_vs_cpu(torch, tok, suites,
                                                    heldout_kw, *final)
    return runs


def profile_evals(torch, tok, suites, heldout_kw, cfg, params):
    """One stage's evals (held-out CE, then each suite of ``chat_suite``)
    on the hybrid run's final parameters under torch.profiler: the wall
    seconds of each part, the device's busy share of the whole, and the
    kernels that take the most device time."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import Engine
    from repro_torch.evals import (arith_exact, heldout_metrics,
                                   mc_accuracy, pattern_exact)
    eng = Engine(cfg, params, tok, device="cuda")
    parts = (("heldout", lambda: heldout_metrics(engine=eng, **heldout_kw)),
             ("mc", lambda: mc_accuracy(eng, tok, suites["mc"])),
             ("arith", lambda: arith_exact(eng, tok, suites["arith"])),
             ("pattern", lambda: pattern_exact(eng, tok, suites["pattern"])))
    walls = {}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for name, fn in parts:
            t1 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls[name] = time.perf_counter() - t1
        wall = time.perf_counter() - t0
    del eng
    by_name = device_time_by_kernel(torch, prof)
    busy_s = sum(by_name.values()) / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    out = {"wall_s": wall, "part_wall_s": walls, "device_busy_s": busy_s,
           "busy_share": busy_s / wall if by_name else None,
           "top_kernels_ms": [(k, us / 1e3) for k, us in top]}
    log(f"  profiled evals (hybrid final params): wall {wall:.3f} s "
        f"({', '.join(f'{k} {v:.3f} s' for k, v in walls.items())}), "
        + (f"device busy {busy_s:.3f} s ({100 * busy_s / wall:.1f}%)"
           if by_name else "profiler: no device time recorded (not "
           "measured)"))
    for k, ms in out["top_kernels_ms"]:
        log(f"    {ms:9.2f} ms  {100 * ms / 1e3 / busy_s:5.1f}%  {k[:90]}")
    return out


def pipeline_vs_cpu(torch, tok, suites, heldout_kw, cfg, params):
    """The hybrid run's final parameters, card against CPU: held-out CE,
    the MC option scores, and the greedy rows of the first
    ``CPU_GEN_ITEMS`` items of each generative suite."""
    import numpy as np

    from repro_torch import Engine
    from repro_torch.evals import heldout_metrics
    from repro_torch.models.transformer import flatten, unflatten
    params_h = unflatten({k: v.cpu() for k, v in flatten(params).items()})
    t0 = time.perf_counter()
    rows = [(tok.encode(it["prompt"]), tok.encode(o + " "))
            for it in suites["mc"] for o in it["options"]]
    eos = tok.special_id("<|assistant_end|>")
    out = {}
    for dev, p in (("cuda", params), ("cpu", params_h)):
        eng = Engine(cfg, p, tok, device=dev)
        gen = {name: eng.generate([tok.encode(it["prompt"]) for it in
                                   suites[name][:CPU_GEN_ITEMS]],
                                  max_new=8, greedy=True, eos_id=eos)
               for name in ("arith", "pattern")}
        out[dev] = (heldout_metrics(engine=eng, **heldout_kw)["heldout_ce"],
                    eng.score_continuations_batch(rows), gen)
        del eng
    (ce_d, sc_d, gen_d), (ce_h, sc_h, gen_h) = out["cuda"], out["cpu"]
    e_ce = abs(ce_d - ce_h) / abs(ce_h)
    e_sc = float(np.max(np.abs(sc_d - sc_h) / np.maximum(np.abs(sc_h),
                                                         1e-30)))
    agree = {name: token_agreement(gen_d[name], gen_h[name])
             for name in gen_d}
    log(f"  hybrid final params, card vs CPU ({time.perf_counter() - t0:.1f}"
        f" s): heldout_ce {ce_d!r} vs {ce_h!r} (rel {e_ce:.2e}, rtol "
        f"1e-4); MC option scores (128 rows) rel err {e_sc:.2e} (1e-3); "
        f"greedy-token agreement over the first {CPU_GEN_ITEMS} items "
        f"{agree} (not gated)")
    check(e_ce <= 1e-4, "pipeline: heldout_ce on the card disagrees with "
          "the CPU")
    check(e_sc <= 1e-3, "pipeline: MC option scores on the card disagree "
          "with the CPU")
    return {"heldout_ce": [ce_d, ce_h], "mc_score_rel_err": e_sc,
            "greedy_agreement": agree}


# ---------------------------------------------------------------------------
# Phase 6b: remat, run checkpoints and resume, prefetch and eval hooks, drift
# ---------------------------------------------------------------------------

# remat at phase 5's shape: one training step off and on, then one DiLoCo
# round (H 1) per (K, remat) plan: peak memory and seconds
REMAT_TOKENS = dict(per_worker_batch=4, seq_len=TRAIN_SEQ)
REMAT_PLANS = ((2, False), (2, True), (4, True), (4, False))
# resume, prefetch and the eval hook at depth 2 and full width (vocab
# 512): (path, DiLoCoConfig fields, steps, checkpoint_every)
RESUME_DEPTH = 2
RESUME_PLANS = (("diloco_int8", dict(strategy="diloco", delta_dtype="int8"),
                 4, 2),
                ("pipelined_int8", dict(strategy="pipelined",
                                        delta_dtype="int8", num_fragments=2,
                                        sync_delay=1), 4, 2))
RESUME_KW = dict(workers=2, h=2, per_worker_batch=8, seq_len=128)
PREFETCH_DEPTH = 4
EVAL_EVERY = 3
# drift on a short DiLoCo run at nanochat-d20's full width, cut to 10
# layers for the script's time since phases 4b and 6e joined (its float64
# CPU copies took 18.45 s at 20 layers)
DRIFT_KW = dict(steps=4, h=2, per_worker_batch=8, seq_len=128)
DRIFT_LAYERS = 10
DRIFT_RANK = 8
TOL_DRIFT = {"param_drift": 1e-5, "worker_cka": 1e-4}   # rtol, vs f64 CPU
# the card's memory a K 4 pipeline must leave free to move phase 6 to K 4
PIPELINE_K4_HEADROOM_GB = 8.0


class _KeepRunner:
    """A strategy that hands out its runner: the resume gates compare the
    runner's error-feedback residual, which ``DistTrainer.run`` keeps."""

    def __init__(self, strategy):
        self.strategy, self.runner = strategy, None

    def bind(self, engine, params):
        self.runner = self.strategy.bind(engine, params)
        return self.runner

    def __getattr__(self, name):
        return getattr(self.strategy, name)


def tree_bits_equal(torch, a, b) -> bool:
    """Same paths, dtypes and bits in two trees (states, residuals)."""
    from repro_torch.checkpoint.checkpoint import _leaves
    la, lb = _leaves(a), _leaves(b)
    if [p for p, _ in la] != [p for p, _ in lb]:
        return False
    return all(x.dtype == y.dtype and torch.equal(x, y)
               for (_, x), (_, y) in zip(la, lb))


def phase_state(torch):
    """Remat, run checkpoints and resume, prefetch and the eval hook, and
    the drift diagnostics, on the card (see the module docstring)."""
    from repro_torch.kernels import KERNELS, launches, reset_launches
    out, paths = {}, {}
    t0 = time.perf_counter()
    out["remat"] = remat_runs(torch, paths)
    log(f"  remat: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    out["resume"] = resume_runs(torch, paths)
    log(f"  resume, prefetch, eval hook: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    k4 = out["remat"]["rounds"].get("k4_remat")
    free_gb = (torch.cuda.get_device_properties(0).total_memory / 1e9
               - k4["peak_memory_gb"]) if k4 else 0.0
    out["pipeline_k4_fits"] = free_gb >= PIPELINE_K4_HEADROOM_GB
    log(f"  K 4 with remat leaves {free_gb:.1f} GB of the card free at "
        f"phase 5's shape (phase 6 moves to K 4 at >= "
        f"{PIPELINE_K4_HEADROOM_GB} GB): "
        + ("fits" if out["pipeline_k4_fits"] else "does not fit"))
    reset_launches()
    out["drift"] = drift_run(torch, 4 if out["pipeline_k4_fits"] else 2)
    paths["drift"] = {k: launches[k] for k in KERNELS}
    log(f"  drift: {time.perf_counter() - t0:.1f} s")
    for name, counts in paths.items():
        for k in ("rmsnorm", "rmsnorm_residual", "flash_fwd"):
            check(counts[k] > 0, f"{name}: kernel {k} never launched")
    out["launches"] = paths
    return out


def remat_runs(torch, paths):
    """nanochat-d20 at full width and depth (vocab 65536, f32) at phase 5's
    shape: one training step with remat off and on (loss and every
    gradient equal bit for bit, the forward kernels launched twice under
    remat, the backward kernels once), then the peak memory and seconds
    of one DiLoCo round (H 1, fused AdamW) for each of ``REMAT_PLANS``
    (the second of two rounds is timed; the peak is over both).  K 4
    without remat runs only when the K 2 rounds reckon it fits."""
    from repro_torch.configs import (NANOCHAT_D20, DiLoCoConfig,
                                     OptimizerConfig)
    from repro_torch.core import DistTrainer, make_strategy
    from repro_torch.kernels import KERNELS, launches, reset_launches
    from repro_torch.launch.train import build_pipeline
    from repro_torch.models import init_params, lm_loss
    from repro_torch.models.transformer import flatten, unflatten
    _, _, stages, _ = build_pipeline(seq_len=REMAT_TOKENS["seq_len"])
    ds = stages["base"]
    B = REMAT_TOKENS["per_worker_batch"]
    batch = {k: torch.from_numpy(v).cuda() for k, v in
             ds.batch(0, B).items()}
    params = flatten(init_params(NANOCHAT_D20, seed=0, device="cuda"))
    step = {}
    for remat in (False, True):
        cfg = NANOCHAT_D20.with_(remat=remat)
        leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        loss, _ = lm_loss(unflatten(leaves), batch, cfg)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        torch.cuda.synchronize()
        step[remat] = (loss.detach(), dict(zip(leaves, grads)),
                       {k: launches[k] for k in KERNELS},
                       time.perf_counter() - t0,
                       torch.cuda.max_memory_allocated() / 1e9)
        paths[f"remat_step_{'on' if remat else 'off'}"] = step[remat][2]
        del leaves, grads, loss
    (l0, g0, c0, s0, m0), (l1, g1, c1, s1, m1) = step[False], step[True]
    same = bool(torch.equal(l0, l1)) and all(torch.equal(g0[k], g1[k])
                                             for k in g0)
    log(f"  one training step, nanochat-d20 B {B} x S "
        f"{REMAT_TOKENS['seq_len']}: loss {float(l0)!r} (remat off) vs "
        f"{float(l1)!r} (on); loss and {len(g0)} gradients equal bit for "
        f"bit: {same}; {s0:.3f} s / {s1:.3f} s, peak {m0:.2f} / {m1:.2f} "
        f"GB; launches off {({k: v for k, v in c0.items() if v})} on "
        f"{({k: v for k, v in c1.items() if v})}")
    check(same, "remat on and off give other bits")
    check(c1["flash_fwd"] == 2 * c0["flash_fwd"] > 0
          and c1["flash_bwd"] == c0["flash_bwd"] > 0
          and c1["rmsnorm_bwd"] == c0["rmsnorm_bwd"] > 0,
          "remat: the forward kernels did not launch twice, or the "
          "backward's count moved")
    del step, g0, g1
    torch.cuda.empty_cache()
    opt_cfg = OptimizerConfig(total_steps=4, warmup_steps=1,
                              learning_rate=0.02, adam_lr=1e-3,
                              fused_adamw=True)
    rounds = {}
    for k, remat in REMAT_PLANS:
        name = f"k{k}_{'remat' if remat else 'no_remat'}"
        if k == 4 and not remat:
            fit = reckon_k4(torch, rounds)
            rounds["k4_no_remat_reckoning"] = fit
            if not fit["fits"]:
                log(f"  K 4 without remat not run: {fit['text']}")
                continue
        cfg = NANOCHAT_D20.with_(remat=remat)
        dcfg = DiLoCoConfig(num_workers=k, h_inner_steps=1)
        dt = DistTrainer(lambda p, b: lm_loss(p, b, cfg), opt_cfg, dcfg,
                         make_strategy(dcfg))
        eng = dt.engine()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        state = dt.init(unflatten(params))
        times = []
        for r in range(2):
            wb = {n: torch.from_numpy(v).cuda() for n, v in
                  ds.worker_batches(r, k, B).items()}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, losses = eng.inner_step(state, wb)
            state = eng.outer_step(state)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated() / 1e9
        paths[f"remat_{name}"] = {n: launches[n] for n in KERNELS}
        rounds[name] = {"workers": k, "remat": remat, "round_s": times[-1],
                        "rounds_s": times, "peak_memory_gb": peak,
                        "tokens_per_s": k * B * REMAT_TOKENS["seq_len"]
                        / times[-1],
                        "loss": [float(x) for x in losses.cpu()]}
        log(f"  one DiLoCo round (H 1), K {k}, remat "
            f"{'on' if remat else 'off'}: {times[-1]:.3f} s (first round "
            f"{times[0]:.3f} s), peak {peak:.2f} GB, "
            f"{rounds[name]['tokens_per_s']:.0f} tokens/s")
        check(all(math.isfinite(x) for x in rounds[name]["loss"]),
              f"remat {name}: non-finite loss")
        del state, eng, dt, wb, losses
        torch.cuda.empty_cache()
    del params, batch
    torch.cuda.empty_cache()
    return {"step_bits_equal": same, "step_s": [s0, s1],
            "step_peak_gb": [m0, m1], "step_launches": [c0, c1],
            "rounds": rounds}


def reckon_k4(torch, rounds):
    """Whether K 4 without remat fits, from the K 2 and K 4 rounds
    measured: two more workers' state (the K 4 and K 2 peaks with remat
    apart) on top of the K 2 peak without remat, against the card."""
    total = torch.cuda.get_device_properties(0).total_memory / 1e9
    per_two = (rounds["k4_remat"]["peak_memory_gb"]
               - rounds["k2_remat"]["peak_memory_gb"])
    want = rounds["k2_no_remat"]["peak_memory_gb"] + per_two
    fits = want < total - 2.0
    text = (f"K 2 without remat {rounds['k2_no_remat']['peak_memory_gb']:.2f}"
            f" GB + two workers' state {per_two:.2f} GB (K 4 minus K 2 with "
            f"remat) = {want:.2f} GB of {total:.2f}")
    return {"fits": fits, "want_gb": want, "total_gb": total, "text": text}


def resume_runs(torch, paths):
    """Depth 2, full width (vocab 512), K 2, H 2, 4 steps, for each of
    ``RESUME_PLANS``: an uninterrupted run writing a checkpoint every 2
    steps; a run resumed from its first checkpoint (later manifests
    removed) into fresh state: the state (anchor, outer momentum and
    counter, every worker's parameters and optimizer state, the step) and
    the runner's residual equal bit for bit, and the losses recorded.  For
    DiLoCo also a run with prefetch ``PREFETCH_DEPTH`` and the eval hook
    every ``EVAL_EVERY`` steps: the same bits as the run without, the hook
    called at the expected steps.  Checkpoints go to a temporary directory
    under build/, removed afterwards."""
    import os
    import shutil
    import tempfile
    from repro_torch.checkpoint import list_run_checkpoints
    from repro_torch.configs import DiLoCoConfig, OptimizerConfig
    from repro_torch.core import DistTrainer, make_strategy
    from repro_torch.kernels import KERNELS, launches, reset_launches
    from repro_torch.launch.train import build_pipeline, make_model
    from repro_torch.models import init_params, lm_loss
    _, tok, stages, _ = build_pipeline(seq_len=RESUME_KW["seq_len"])
    ds = stages["base"]
    cfg = make_model("nanochat-d20", False, tok.vocab_size).with_(
        num_layers=RESUME_DEPTH)
    params = init_params(cfg, seed=0, device="cuda")
    opt_cfg = OptimizerConfig(total_steps=8, warmup_steps=1,
                              learning_rate=0.02, adam_lr=1e-3,
                              fused_adamw=True)
    K = RESUME_KW["workers"]

    def data(s):
        return ds.worker_batches(s, K, RESUME_KW["per_worker_batch"])

    def run(dkw, steps, **kw):
        dcfg = DiLoCoConfig(num_workers=K, h_inner_steps=RESUME_KW["h"],
                            **dkw)
        keep = _KeepRunner(make_strategy(dcfg))
        dt = DistTrainer(lambda p, b: lm_loss(p, b, cfg), opt_cfg, dcfg,
                         keep)
        state, hist = dt.run(dt.init(params), data, steps, **kw)
        return state, keep.runner.residual, hist

    root = ROOT / "build"
    root.mkdir(exist_ok=True)
    out = {}
    for path, dkw, steps, every in RESUME_PLANS:
        d = tempfile.mkdtemp(prefix="resume_", dir=root)
        try:
            reset_launches()
            t0 = time.perf_counter()
            a_state, a_res, a_hist = run(dkw, steps, checkpoint_dir=d,
                                         checkpoint_every=every)
            torch.cuda.synchronize()
            t_a = time.perf_counter() - t0
            paths[f"resume_{path}"] = {k: launches[k] for k in KERNELS}
            written = [s for s, _ in list_run_checkpoints(d)]
            nbytes = sum(os.path.getsize(os.path.join(d, f))
                         for f in os.listdir(d))
            first = written[0]
            for s, man in list_run_checkpoints(d)[1:]:
                os.remove(man)
            t0 = time.perf_counter()
            b_state, b_res, b_hist = run(dkw, steps, checkpoint_dir=d,
                                         resume=True)
            torch.cuda.synchronize()
            t_b = time.perf_counter() - t0
            same = (tree_bits_equal(torch, a_state, b_state)
                    and tree_bits_equal(torch, a_res, b_res)
                    and a_hist["loss"] == b_hist["loss"]
                    and a_hist["sync_steps"] == b_hist["sync_steps"]
                    and a_hist["frag_syncs"] == b_hist["frag_syncs"])
            out[path] = {"checkpoints": written, "resumed_from": first,
                         "checkpoint_bytes": nbytes, "run_s": t_a,
                         "resume_s": t_b, "bits_equal": same,
                         "loss": a_hist["loss"],
                         "sync_steps": a_hist["sync_steps"],
                         "frag_syncs": a_hist["frag_syncs"]}
            log(f"  {path}: checkpoints at {written} ({nbytes / 1e9:.2f} GB "
                f"on disk), resumed from {first} into fresh state: state "
                f"and residual equal bit for bit: {same}; losses "
                f"{[round(x, 4) for x in a_hist['loss']]}; run {t_a:.1f} s, "
                f"resume {t_b:.1f} s")
            check(same, f"{path}: the resumed run differs from the "
                  f"uninterrupted one")
            check(a_res is not None, f"{path}: no error-feedback residual")
            if path == "diloco_int8":
                seen = []
                c_state, c_res, c_hist = run(
                    dkw, steps, prefetch=PREFETCH_DEPTH,
                    eval_fn=lambda g: seen.append(1) or float(
                        g["final_norm/scale"].sum()),
                    eval_every=EVAL_EVERY)
                want = [s - 1 for s in range(EVAL_EVERY, steps + 1,
                                             EVAL_EVERY)]
                got = [s for s, _ in c_hist["evals"]]
                pf_same = (tree_bits_equal(torch, a_state, c_state)
                           and tree_bits_equal(torch, a_res, c_res)
                           and a_hist["loss"] == c_hist["loss"])
                out[path].update(prefetch_bits_equal=pf_same,
                                 eval_steps=got)
                log(f"  {path}: prefetch {PREFETCH_DEPTH} with the eval "
                    f"hook every {EVAL_EVERY} steps: the same bits as "
                    f"prefetch 0: {pf_same}; evals at steps {got} "
                    f"(want {want})")
                check(pf_same, "prefetch changed the run's bits")
                check(got == want and len(seen) == len(want),
                      "the eval hook ran at other steps")
                del c_state, c_res
            del a_state, b_state, a_res, b_res
        finally:
            shutil.rmtree(d, ignore_errors=True)
        torch.cuda.empty_cache()
    return out


def drift_run(torch, k):
    """A short DiLoCo run of nanochat-d20 (full width, ``DRIFT_LAYERS``
    layers, vocab 512) at K ``k``, H 2, 4 steps of 8 x 128 tokens a worker, through the
    trainer's inner and outer steps; before the last sync: ``param_drift``
    on the card against the same function on float64 CPU copies (rtol
    ``TOL_DRIFT``), ``worker_cka_matrix`` of the workers' final-normed
    hidden states (``forward_hidden``) on an 8 x 128 probe batch, card
    against the same on float64 CPU copies of those states, and the
    ``linear_cka`` and ``subspace_overlap`` (r 8) of workers 0 and 1."""
    from repro_torch.configs import DiLoCoConfig, OptimizerConfig
    from repro_torch.core import DistTrainer, drift, make_strategy
    from repro_torch.launch.train import build_pipeline, make_model
    from repro_torch.models import init_params, lm_loss
    from repro_torch.models.transformer import forward_hidden, unflatten
    _, tok, stages, _ = build_pipeline(seq_len=DRIFT_KW["seq_len"])
    ds = stages["base"]
    cfg = make_model("nanochat-d20", False, tok.vocab_size).with_(
        num_layers=DRIFT_LAYERS)
    dcfg = DiLoCoConfig(num_workers=k, h_inner_steps=DRIFT_KW["h"])
    dt = DistTrainer(lambda p, b: lm_loss(p, b, cfg),
                     OptimizerConfig(total_steps=DRIFT_KW["steps"],
                                     warmup_steps=1, fused_adamw=True),
                     dcfg, make_strategy(dcfg))
    eng = dt.engine()
    state = dt.init(init_params(cfg, seed=0, device="cuda"))
    for s in range(DRIFT_KW["steps"]):
        wb = {n: torch.from_numpy(v).cuda() for n, v in
              ds.worker_batches(s, k, DRIFT_KW["per_worker_batch"]).items()}
        state, _ = eng.inner_step(state, wb)
        if (s + 1) % DRIFT_KW["h"] == 0 and s + 1 < DRIFT_KW["steps"]:
            state = eng.outer_step(state)
    t0 = time.perf_counter()
    d_card = {n: float(v) for n, v in drift.param_drift(
        state.worker_params, state.global_params).items()}
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    d_cpu = {n: float(v) for n, v in drift.param_drift(
        [{n: v.double().cpu() for n, v in w.items()}
         for w in state.worker_params],
        {n: v.double().cpu() for n, v in state.global_params.items()}
    ).items()}
    t_cpu = time.perf_counter() - t0
    e_drift = max(abs(d_card[n] - d_cpu[n]) / max(abs(d_cpu[n]), 1e-30)
                  for n in d_cpu)
    probe = {n: torch.from_numpy(v).cuda() for n, v in
             ds.batch(999999, DRIFT_KW["per_worker_batch"]).items()}
    with torch.no_grad():
        acts = [forward_hidden(unflatten(w), probe, cfg)[0]
                for w in state.worker_params]
        cka_card = drift.worker_cka_matrix(acts, lambda a, _: a, probe)
        acts64 = [a.double().cpu() for a in acts]
        cka_cpu = drift.worker_cka_matrix(acts64, lambda a, _: a, probe)
        e_cka = float(((cka_card.double().cpu() - cka_cpu).abs()
                       / cka_cpu.abs().clamp(min=1e-30)).max())
        x = acts[0].reshape(-1, acts[0].shape[-1])
        y = acts[1].reshape(-1, acts[1].shape[-1])
        cka01 = float(drift.linear_cka(x, y))
        sub01 = float(drift.subspace_overlap(x, y, r=DRIFT_RANK))
    off = ((float(cka_card.sum()) - k) / (k * (k - 1)))
    log(f"  drift, nanochat-d20 ({cfg.num_layers} layers, vocab "
        f"{cfg.vocab_size}), K {k}, H "
        f"{DRIFT_KW['h']}, before the sync at step {DRIFT_KW['steps']}: "
        + " ".join(f"{n}={v:.6g}" for n, v in d_card.items())
        + f" (card {t_card:.2f} s; float64 CPU {t_cpu:.2f} s; worst rel "
        f"{e_drift:.2e}, rtol {TOL_DRIFT['param_drift']:g}); worker CKA "
        f"off-diagonal mean {off:.8f} (vs float64 CPU worst rel "
        f"{e_cka:.2e}, rtol {TOL_DRIFT['worker_cka']:g}); workers 0 and 1: "
        f"linear_cka {cka01:.8f}, subspace_overlap_r{DRIFT_RANK} "
        f"{sub01:.6f}")
    check(e_drift <= TOL_DRIFT["param_drift"],
          "param_drift on the card disagrees with float64 on the CPU")
    check(e_cka <= TOL_DRIFT["worker_cka"],
          "worker_cka_matrix on the card disagrees with float64 on the CPU")
    return {"workers": k, "param_drift": d_card, "param_drift_cpu64": d_cpu,
            "param_drift_rel_err": e_drift, "worker_cka_offdiag": off,
            "worker_cka_rel_err": e_cka,
            "worker_cka": cka_card.cpu().tolist(), "linear_cka_01": cka01,
            f"subspace_overlap_r{DRIFT_RANK}_01": sub01}


# ---------------------------------------------------------------------------
# Phase 6c: gossip and async gossip over the codec wire
# ---------------------------------------------------------------------------

# Table 1's model and shape: nanochat-d20 at full width (vocab 512), K 4,
# per-worker batch 8, seq_len 128, H 2, the int8 wire, fused AdamW, remat
# on; (path, method, DiLoCoConfig fields, steps)
GOSSIP_KW = dict(workers=4, per_worker_batch=8, h=2)
GOSSIP_SEQ = 128
GOSSIP_PLANS = (("gossip", "gossip", dict(topology="ring"), 4),
                ("gossip_random", "gossip", dict(topology="random"), 4),
                # sync_seed 0 draws the periods (3, 3, 2, 3)
                ("async_gossip", "async_gossip",
                 dict(h_jitter=1, staleness_bound=1), 6))
# async gossip's depth when its three publication boards (3 x K f32
# copies of the model, 25.2 GB at full depth) do not fit beside the
# gossip run's measured peak
GOSSIP_ASYNC_DEPTH = 10
GOSSIP_IDLE = tuple(k for k in REPLACES
                    if k not in TRAIN_KERNELS + WIRE_KERNELS)
# resume and the jitter-0 equality at depth 2 (full width, vocab 512)
GOSSIP_STATE_DEPTH = 2
GOSSIP_RESUME = (("gossip", dict(strategy="gossip")),
                 ("async_gossip", dict(strategy="async_gossip", h_jitter=1,
                                       staleness_bound=1)))
# the comm report: Table 1's base stage (300 steps, H 100) of this model
# at the step seconds measured here, on a fleet of these relative speeds
GOSSIP_SPEEDS = (1.0, 1.0, 1.5, 2.0)
GOSSIP_REPORT = dict(steps=300, h=100)


def gossip_wire_bytes(records, n_params, n_leaves, bound=None):
    """The wire bytes the port counts for one run from its records: each
    worker's read of another's payload (the int8 codes, one 4-byte scale
    per leaf, and the f32 anchors and momentum: 9 bytes a parameter);
    async gossip reads only the contributions it consumes (another
    worker, staleness 0 to ``bound``)."""
    reads = sum(1 for _, w, p, s in records
                if p != w and (bound is None or 0 <= s <= bound))
    return reads * (9 * n_params + 4 * n_leaves)


def phase_gossip(torch, diloco_step_s):
    """Gossip (ring, random) and async gossip (jitter 1, bound 1) at
    ``GOSSIP_PLANS`` through ``run_stage``, each from fresh parameters,
    launch counts and the wire's byte count reset just before each run:
    losses finite and falling; the ``gossip_syncs`` and ``sync_steps``
    records equal to the same run's on the CPU (a tiny model: the records
    are the schedule's); the training and wire kernels launched and no
    other; the counted wire bytes equal to the records' reads (for
    gossip, per worker per round: ``payload_schedule``'s plus the scales'
    4 bytes a leaf, which the schedule does not count); step seconds and
    peak memory.  Async gossip runs at full depth when the gossip run's
    peak plus its boards reckon it fits, else at ``GOSSIP_ASYNC_DEPTH``.
    Then at depth 2: async gossip with jitter 0 and bound 0 equal to
    gossip bit for bit (K 4, int8), and resume == uninterrupted bit for
    bit for both strategies (state and the runner's anchors, momentum,
    residual and boards).  Then ``comm_report`` for diloco (at
    ``diloco_step_s``, phase 6's base stage), gossip and async gossip
    over ``GOSSIP_SPEEDS``."""
    import dataclasses
    from repro_torch.configs import DiLoCoConfig, OptimizerConfig
    from repro_torch.core import make_strategy, transport
    from repro_torch.kernels import KERNELS, launches, reset_launches
    from repro_torch.launch.train import (build_pipeline, comm_report,
                                          make_model, run_stage)
    from repro_torch.models import init_params
    from repro_torch.models.transformer import flatten
    _, tok, stages, _ = build_pipeline(seq_len=GOSSIP_SEQ)
    ds = stages["base"]
    full = make_model("nanochat-d20", False, tok.vocab_size)
    tiny = make_model("tiny", True, tok.vocab_size)
    opt_cfg = OptimizerConfig(total_steps=8, warmup_steps=1,
                              learning_rate=0.02, adam_lr=1e-3,
                              fused_adamw=True)
    K, h = GOSSIP_KW["workers"], GOSSIP_KW["h"]
    total_gb = torch.cuda.get_device_properties(0).total_memory / 1e9
    out, paths = {"runs": {}}, {}
    for path, method, dkw, steps in GOSSIP_PLANS:
        t_path = time.perf_counter()
        dcfg = DiLoCoConfig(delta_dtype="int8", **dkw)
        cfg = full
        if method == "async_gossip":
            n_full = out["runs"]["gossip"]["n_params"]
            boards = 3 * K * 4 * n_full / 1e9
            want = out["runs"]["gossip"]["peak_memory_gb"] + boards
            fits = want < total_gb - 2.0
            cfg = full if fits else full.with_(num_layers=GOSSIP_ASYNC_DEPTH)
            out["async_depth"] = {
                "layers": cfg.num_layers, "want_gb": want,
                "boards_gb": boards, "total_gb": total_gb}
            log(f"  async gossip's boards {boards:.2f} GB + the gossip "
                f"run's peak {out['runs']['gossip']['peak_memory_gb']:.2f} "
                f"GB = {want:.2f} GB of {total_gb:.2f}: "
                + ("full depth" if fits else
                   f"cut to {GOSSIP_ASYNC_DEPTH} layers"))
        params = init_params(cfg, seed=0, device="cuda")
        flat = flatten(params)
        n, n_leaves = sum(p.numel() for p in flat.values()), len(flat)
        del flat
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        transport.reset_shipped()
        t0 = time.perf_counter()
        _, hist = run_stage(method, cfg, params, ds, steps=steps,
                            opt_cfg=opt_cfg, diloco_cfg=dcfg, seed=0,
                            **GOSSIP_KW)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {k: launches[k] for k in KERNELS}
        peak = torch.cuda.max_memory_allocated() / 1e9
        shipped = dict(transport.shipped)
        del params
        torch.cuda.empty_cache()
        _, cpu = run_stage(method, tiny, init_params(tiny, seed=0,
                                                     device="cpu"),
                           ds, steps=steps, opt_cfg=opt_cfg, diloco_cfg=dcfg,
                           seed=0, **dict(GOSSIP_KW, per_worker_batch=1))
        losses, recs = hist["loss"], hist["gossip_syncs"]
        run_cfg = dataclasses.replace(dcfg, num_workers=K, h_inner_steps=h,
                                      strategy=method)
        sched = make_strategy(run_cfg).payload_schedule(n, steps, run_cfg)
        bound = dcfg.staleness_bound if method == "async_gossip" else None
        want_bytes = gossip_wire_bytes(recs, n, n_leaves, bound)
        got_bytes = sum(shipped.values())
        rounds = len(hist["sync_steps"])
        per_round = got_bytes / K / rounds if rounds else None
        run = {"method": method, "config": dkw, "layers": cfg.num_layers,
               "n_params": n, "loss": losses, "sync_steps":
               hist["sync_steps"], "gossip_syncs": recs,
               "step_seconds": hist["step_seconds"],
               "tokens_per_s": K * GOSSIP_KW["per_worker_batch"]
               * GOSSIP_SEQ / hist["step_seconds"],
               "wall_s": wall, "peak_memory_gb": peak, "wire": shipped,
               "wire_bytes_per_worker_per_round": per_round,
               "schedule_bytes_per_worker": sched[0].bytes_per_worker,
               "launches": counts}
        log(f"  run_stage({method!r}) {path} {dkw}, {cfg.num_layers} "
            f"layers ({n} params): losses {[round(x, 4) for x in losses]}, "
            f"syncs {hist['sync_steps']}, gossip_syncs {recs}, step "
            f"{hist['step_seconds']:.3f} s ({run['tokens_per_s']:.0f} "
            f"tokens/s), wall {wall:.2f} s, peak {peak:.2f} GB; wire "
            f"{shipped} (want {want_bytes}), per worker per round "
            f"{per_round} (payload_schedule {sched[0].bytes_per_worker} + "
            f"scales {4 * n_leaves}); launches "
            f"{ {k: v for k, v in counts.items() if v} }")
        check(all(math.isfinite(x) for x in losses),
              f"{path}: non-finite loss")
        check(losses[-1] < losses[0], f"{path}: the loss did not fall")
        check(recs and recs == cpu["gossip_syncs"]
              and hist["sync_steps"] == cpu["sync_steps"],
              f"{path}: records {recs} {hist['sync_steps']} != the CPU "
              f"run's {cpu['gossip_syncs']} {cpu['sync_steps']}")
        check(got_bytes == want_bytes, f"{path}: counted wire bytes "
              f"{got_bytes} != {want_bytes} from the records")
        if method == "gossip":
            check(per_round == sched[0].bytes_per_worker + 4 * n_leaves,
                  f"{path}: wire bytes per worker per round {per_round} != "
                  f"payload_schedule's {sched[0].bytes_per_worker} + "
                  f"{4 * n_leaves} of scales")
        for k in TRAIN_KERNELS + WIRE_KERNELS:
            check(counts[k] > 0, f"{path}: kernel {k} never launched on "
                  f"the main path")
        for k in GOSSIP_IDLE:
            check(counts[k] == 0, f"{path}: kernel {k} launched off its "
                  f"path")
        paths[path] = counts
        out["runs"][path] = run
        log(f"  {path}: {time.perf_counter() - t_path:.1f} s")
    t0 = time.perf_counter()
    out["state"] = gossip_state_runs(torch, tok, ds, opt_cfg)
    log(f"  gossip at depth {GOSSIP_STATE_DEPTH}: jitter 0 == gossip, "
        f"resume: {time.perf_counter() - t0:.1f} s")
    # the gossip strategies at the faster of the two full-depth gossip
    # runs' steps (the same work; the first run may pay warm-up)
    gossip_s = min(out["runs"][p]["step_seconds"]
                   for p in ("gossip", "gossip_random"))
    reports = {}
    for method, dkw, step_s in (
            ("diloco", {}, diloco_step_s),
            ("gossip", {}, gossip_s),
            ("async_gossip", GOSSIP_PLANS[2][2], gossip_s)):
        dcfg = DiLoCoConfig(num_workers=K, delta_dtype="int8", **dkw)
        rep = comm_report(dcfg, method, out["runs"]["gossip"]["n_params"],
                          GOSSIP_REPORT["steps"], GOSSIP_REPORT["h"],
                          step_s, GOSSIP_SPEEDS)
        reports[method] = rep
        pair = (f", pair barriers {rep['gossip']['wall_clock_s']:.4f} s"
                if "gossip" in rep else "")
        homo, het = rep["homogeneous"], rep["heterogeneous"]
        log(f"  comm_report {method} (int8, K {K}, {GOSSIP_REPORT}, step "
            f"{step_s:.4f} s, speeds {GOSSIP_SPEEDS}, link "
            f"{rep['link_bytes_per_s']:.4g} B/s, latency "
            f"{rep['link_latency_s']} s): {homo['total_bytes']:.0f} bytes a "
            f"worker; homogeneous {homo['wall_clock_s']:.4f} s (stall "
            f"{homo['stall_s']:.4f}); heterogeneous "
            f"{het['wall_clock_s']:.4f} s (stall {het['stall_s']:.4f})"
            f"{pair}")
    out["comm_report"] = reports
    out["launches"] = paths
    return out


def gossip_state_runs(torch, tok, ds, opt_cfg):
    """Depth 2, full width (vocab 512), K 4, H 2, the int8 wire, through
    ``DistTrainer``: async gossip with jitter 0 and bound 0 against
    gossip (state, records, bit for bit), then for each of
    ``GOSSIP_RESUME`` a run writing a checkpoint at step 2 and one
    resumed from it into fresh state: the state and the runner's extras
    (anchors, momentum, residual, boards) equal bit for bit."""
    import os
    import shutil
    import tempfile
    from repro_torch.checkpoint import list_run_checkpoints
    from repro_torch.configs import DiLoCoConfig
    from repro_torch.core import (AsyncGossipSync, DistTrainer, GossipSync,
                                  make_strategy)
    from repro_torch.launch.train import make_model
    from repro_torch.models import init_params, lm_loss
    cfg = make_model("nanochat-d20", False, tok.vocab_size).with_(
        num_layers=GOSSIP_STATE_DEPTH)
    params = init_params(cfg, seed=0, device="cuda")
    K, B = GOSSIP_KW["workers"], GOSSIP_KW["per_worker_batch"]

    def run(dcfg, strategy, steps, **kw):
        keep = _KeepRunner(strategy)
        dt = DistTrainer(lambda p, b: lm_loss(p, b, cfg), opt_cfg, dcfg,
                         keep)
        state, hist = dt.run(dt.init(params),
                             lambda s: ds.worker_batches(s, K, B), steps,
                             **kw)
        return state, keep.runner.checkpoint_extras()[0], hist

    out = {}
    dcfg = DiLoCoConfig(num_workers=K, h_inner_steps=GOSSIP_KW["h"],
                        delta_dtype="int8")
    a = run(dcfg, GossipSync(), 4)
    b = run(dcfg, AsyncGossipSync(), 4)
    same = (tree_bits_equal(torch, a[0], b[0])
            and tree_bits_equal(torch, a[1], b[1])
            and a[2]["loss"] == b[2]["loss"]
            and a[2]["gossip_syncs"] == b[2]["gossip_syncs"])
    out["async_j0_b0_bits_equal"] = same
    log(f"  async gossip, jitter 0, bound 0 == gossip (K {K}, int8, depth "
        f"{GOSSIP_STATE_DEPTH}): {same}; gossip_syncs "
        f"{a[2]['gossip_syncs']}")
    check(same, "async gossip with jitter 0 and bound 0 differs from gossip")
    del a, b
    root = ROOT / "build"
    root.mkdir(exist_ok=True)
    for path, dkw in GOSSIP_RESUME:
        dcfg = DiLoCoConfig(num_workers=K, h_inner_steps=GOSSIP_KW["h"],
                            delta_dtype="int8", **dkw)
        d = tempfile.mkdtemp(prefix="gossip_resume_", dir=root)
        try:
            t0 = time.perf_counter()
            a = run(dcfg, make_strategy(dcfg), 3, checkpoint_dir=d,
                    checkpoint_every=2)
            written = [s for s, _ in list_run_checkpoints(d)]
            nbytes = sum(os.path.getsize(os.path.join(d, f))
                         for f in os.listdir(d))
            b = run(dcfg, make_strategy(dcfg), 3, checkpoint_dir=d,
                    resume=True)
            same = (tree_bits_equal(torch, a[0], b[0])
                    and tree_bits_equal(torch, a[1], b[1])
                    and a[2]["loss"] == b[2]["loss"]
                    and a[2]["gossip_syncs"] == b[2]["gossip_syncs"])
            out[f"resume_{path}"] = {"checkpoints": written,
                                     "checkpoint_bytes": nbytes,
                                     "bits_equal": same,
                                     "gossip_syncs": a[2]["gossip_syncs"]}
            log(f"  {path}: checkpoint at {written} ({nbytes / 1e9:.2f} GB "
                f"on disk), resumed into fresh state: state and runner "
                f"extras equal bit for bit: {same}; gossip_syncs "
                f"{a[2]['gossip_syncs']}; {time.perf_counter() - t0:.1f} s")
            check(written == [2] and same, f"{path}: the resumed run "
                  f"differs from the uninterrupted one")
            del a, b
        finally:
            shutil.rmtree(d, ignore_errors=True)
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Phase 6d: the fault layer
# ---------------------------------------------------------------------------

# the full-width faulted runs at Table 1's shape (phase 6c's): K 4,
# per-worker batch 8, seq_len 128, H 2, the int8 wire, fused AdamW, remat
# on; (path, method, layers, steps, schedule, gates: quorum, sync_steps).
# Gossip runs at 10 layers: with it at 20 the script took 1008.2 s of its
# 1200 on an H100 80GB HBM3 (PERF.md §6); DiLoCo too since phases 4b and
# 6e joined (at 20 layers the script passed 1200 s on the same card)
FAULT_PLANS = (
    ("faults_diloco", "diloco", 10, 8,
     "slow:3@1x1.5,crash:2@2,drop:1@3,corrupt:0@5x2,rejoin:2@6",
     [(1, 4), (3, 3), (5, 2), (7, 3)], [1, 3, 5, 7]),
    ("faults_gossip", "gossip", 10, 4, "crash:1@1,rejoin:1@2",
     [(1, 3), (3, 3)], [1, 3]))
# the worker each plan takes down and brings back
FAULT_WORKER = {"faults_diloco": 2, "faults_gossip": 1}
# the rejoin drift on the card against float64 CPU copies of the state
TOL_REJOIN = 1e-5
# the bit-for-bit gates at depth 2 (full width, vocab 512), H 2
FAULT_STATE_DEPTH = 2
# kill -> resume: (path, DiLoCoConfig fields, K, schedule besides the kill)
# (K 2: the checkpoints of a K 4 depth-2 state are ~4 GB each)
FAULT_RESUME = (
    ("diloco_int8", dict(strategy="diloco", delta_dtype="int8"), 2, ""),
    ("ddp", dict(strategy="ddp", h_inner_steps=1, outer_lr=1.0,
                 outer_momentum=0.0, nesterov=False), 1, ""),
    ("streaming_f2_int8", dict(strategy="streaming", delta_dtype="int8",
                               num_fragments=2), 2, ""),
    ("pipelined_f2_delay1_int8", dict(strategy="pipelined",
                                      delta_dtype="int8", num_fragments=2,
                                      sync_delay=1), 2,
     "crash:1@1,rejoin:1@4"))
# the comm report under faults: Table 1's base stage (300 steps, H 100,
# int8, K 4) with the straggler (worker 3, speed 2) down from step 40 to
# the round after 160 and a payload lost twice
FAULT_REPORT_SPEC = "crash:3@40,rejoin:3@160,drop:2@199x2"


def rejoin_drift_cpu64(torch, worker_params, global_params, live, w,
                       snap):
    """``drift.rejoin_drift`` recomputed on float64 CPU copies, one leaf at
    a time: the delta norm of worker ``w`` and its cosine to the live
    workers' mean delta (the mean of the live parameters minus the
    anchor).  Also whether worker ``w`` still holds ``snap`` (its
    parameters at its crash, on the host) bit for bit."""
    rows = [i for i, keep in enumerate(live) if keep]
    sq_w = dot = sq_m = 0.0
    held = snap is not None
    for k, g in global_params.items():
        g = g.cpu().double().reshape(-1)
        m = torch.zeros_like(g)
        for i in rows:
            m += worker_params[i][k].cpu().reshape(-1)
        m /= len(rows)
        m -= g
        row = worker_params[w][k].cpu()
        held = held and torch.equal(row, snap[k])
        dw = row.double().reshape(-1) - g
        sq_w += float(torch.dot(dw, dw))
        dot += float(torch.dot(dw, m))
        sq_m += float(torch.dot(m, m))
        del g, m, row, dw
    norm = math.sqrt(sq_w)
    return (norm, dot / (norm * math.sqrt(sq_m) + 1e-12)), held


class _FaultProbe:
    """Wraps, for one run, the inner step (per step: its live set, the
    training kernels' launches and its seconds between two device
    synchronisations; the down worker's parameters at its first dead
    step, on the host, copied outside the timing), the rejoin drift (the
    card's value beside float64 CPU copies, and whether the down worker
    still holds its parameters of the crash) and ``DistTrainer.run`` (its
    final state).  ``close`` restores all three."""

    def __init__(self, torch, worker):
        from repro_torch.core import diloco, dist_trainer, sync
        from repro_torch.kernels import launches
        self.torch, self.worker = torch, worker
        self.steps, self.rejoins, self.snap, self.state = [], [], None, None
        self._saved = [(diloco.DiLoCoTrainer, "inner_step",
                        diloco.DiLoCoTrainer.inner_step),
                       (sync, "rejoin_drift", sync.rejoin_drift),
                       (dist_trainer.DistTrainer, "run",
                        dist_trainer.DistTrainer.run)]
        inner, drift_fn, run = (f for _, _, f in self._saved)
        probe = self

        def inner_step(eng, state, batches, live=None):
            if (live is not None and not live[worker]
                    and probe.snap is None):
                probe.snap = {k: t.cpu().clone() for k, t in
                              state.worker_params[worker].items()}
            before = {k: launches[k] for k in TRAIN_KERNELS}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = inner(eng, state, batches, live=live)
            torch.cuda.synchronize()
            probe.steps.append((live, {k: launches[k] - before[k]
                                       for k in TRAIN_KERNELS},
                                time.perf_counter() - t0))
            return out

        def rejoin_drift(worker_params, global_params, live, w):
            got = drift_fn(worker_params, global_params, live, w)
            ref, held = rejoin_drift_cpu64(torch, worker_params,
                                           global_params, live, w,
                                           probe.snap)
            probe.rejoins.append((w, got, ref, held))
            return got

        def run_keep(dt, *a, **kw):
            probe.state, hist = run(dt, *a, **kw)
            return probe.state, hist

        diloco.DiLoCoTrainer.inner_step = inner_step
        sync.rejoin_drift = rejoin_drift
        dist_trainer.DistTrainer.run = run_keep

    def close(self):
        for owner, name, f in self._saved:
            setattr(owner, name, f)


def phase_faults(torch, diloco_step_s, gossip_step_s):
    """The fault layer (``FAULT_PLANS``) at full width through
    ``run_stage(faults=...)``, each from fresh parameters with launch
    counts reset just before the run, both at 10 layers: DiLoCo with a
    slowdown, a crash, a dropped and a twice-corrupted payload and a
    rejoin; gossip on the ring with a worker down in round 1 and back in
    round 3.  Gates: the
    quorum and sync records, the ``fault``, ``quorum``, ``sync_steps``,
    ``gossip_syncs`` records and the rejoin's (step, worker) equal to the
    same schedule's on the CPU (a tiny model); one rejoin record, its norm
    and cosine within ``TOL_REJOIN`` of float64 CPU copies of the
    pre-adoption state; the down worker holding its parameters of the
    crash until then; its optimizer state ``init`` after the run; losses
    finite; the training and wire kernels launched and no other; each
    inner step with the worker down launching 3/4 of an all-live step's
    training kernels.  Step seconds and peak memory logged.  Then the
    depth-2 gates (``fault_state_runs``) and the comm report under
    ``FAULT_REPORT_SPEC`` beside the fault-free one."""
    from repro_torch.configs import DiLoCoConfig, OptimizerConfig
    from repro_torch.core import FaultSchedule
    from repro_torch.kernels import KERNELS, launches, reset_launches
    from repro_torch.launch.train import (build_pipeline, comm_report,
                                          make_model, run_stage)
    from repro_torch.checkpoint.checkpoint import _leaves
    from repro_torch.models import init_params
    from repro_torch.models.transformer import flatten
    from repro_torch.optim import nanochat_optimizer
    _, tok, stages, _ = build_pipeline(seq_len=GOSSIP_SEQ)
    ds = stages["base"]
    full = make_model("nanochat-d20", False, tok.vocab_size)
    tiny = make_model("tiny", True, tok.vocab_size)
    opt_cfg = OptimizerConfig(total_steps=8, warmup_steps=1,
                              learning_rate=0.02, adam_lr=1e-3,
                              fused_adamw=True)
    K = GOSSIP_KW["workers"]
    out = {"runs": {}}
    for path, method, layers, steps, spec, quorum, sync_steps in \
            FAULT_PLANS:
        t_path = time.perf_counter()
        down = FAULT_WORKER[path]
        dcfg = DiLoCoConfig(delta_dtype="int8")
        cfg = full.with_(num_layers=layers)
        params = init_params(cfg, seed=0, device="cuda")
        n_params = sum(p.numel() for p in flatten(params).values())
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        probe = _FaultProbe(torch, down)
        try:
            t0 = time.perf_counter()
            _, hist = run_stage(method, cfg, params, ds, steps=steps,
                                opt_cfg=opt_cfg, diloco_cfg=dcfg, seed=0,
                                faults=FaultSchedule.from_spec(spec),
                                **GOSSIP_KW)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            probe.close()
        counts = {k: launches[k] for k in KERNELS}
        peak = torch.cuda.max_memory_allocated() / 1e9
        state = probe.state
        init = nanochat_optimizer(opt_cfg).init(state.worker_params[down])
        opt_fresh = all(torch.equal(a, b) for (_, a), (_, b) in zip(
            _leaves(state.inner_opt[down]), _leaves(init)))
        del state, init, params
        probe.state = None
        torch.cuda.empty_cache()
        _, cpu = run_stage(method, tiny, init_params(tiny, seed=0,
                                                     device="cpu"),
                           ds, steps=steps, opt_cfg=opt_cfg, diloco_cfg=dcfg,
                           seed=0, faults=FaultSchedule.from_spec(spec),
                           **dict(GOSSIP_KW, per_worker_batch=1))
        live_steps = [c for live, c, _ in probe.steps if live is None]
        dead_steps = [c for live, c, _ in probe.steps
                      if live is not None and not live[down]]
        # the first step pays the run's first launches: left out
        live_s = sorted(t for live, _, t in probe.steps[1:] if live is None)
        dead_s = sorted(t for live, _, t in probe.steps
                        if live is not None and not live[down])
        inner_s = {"all_live": live_s[len(live_s) // 2] if live_s else None,
                   "worker_down": dead_s[len(dead_s) // 2]
                   if dead_s else None}
        three_quarters = bool(live_steps and dead_steps) and all(
            4 * c[k] == 3 * live_steps[0][k]
            for c in dead_steps for k in TRAIN_KERNELS) and all(
            c == live_steps[0] for c in live_steps)
        losses = hist["loss"]
        rejoin = hist.get("rejoin_drift", [])
        rel = [max(abs(got[i] - ref[i]) / max(abs(ref[i]), 1e-30)
                   for i in (0, 1)) for _, got, ref, _ in probe.rejoins]
        run = {"method": method, "schedule": spec, "layers": layers,
               "n_params": n_params,
               "loss": losses,
               "quorum": hist["quorum"], "sync_steps": hist["sync_steps"],
               "fault": hist["fault"], "rejoin_drift": rejoin,
               "rejoin_drift_cpu64": [ref for _, _, ref, _ in
                                      probe.rejoins],
               "rejoin_drift_rel_err": rel,
               "held_params_of_the_crash": [h for *_, h in probe.rejoins],
               "optimizer_state_is_init": opt_fresh,
               "inner_step_launches_all_live": live_steps[:1],
               "inner_step_launches_worker_down": dead_steps[:1],
               "inner_step_s": inner_s,
               "step_seconds": hist["step_seconds"], "wall_s": wall,
               "peak_memory_gb": peak, "launches": counts}
        if method == "gossip":
            run["gossip_syncs"] = hist["gossip_syncs"]
        log(f"  run_stage({method!r}, faults={spec!r}), {layers} layers, K "
            f"{K}, "
            f"int8: losses {[round(x, 4) for x in losses]}, quorum "
            f"{hist['quorum']}, syncs {hist['sync_steps']}, fault "
            f"{hist['fault']}, rejoin_drift {rejoin} (float64 CPU "
            f"{run['rejoin_drift_cpu64']}, worst rel {rel}), worker {down} "
            f"held its parameters of the crash: "
            f"{run['held_params_of_the_crash']}, optimizer state == init "
            f"after the rejoin: {opt_fresh}; inner-step launches all live "
            f"{live_steps[:1]}, worker {down} down {dead_steps[:1]}; inner "
            f"step (median, synchronised) all live {inner_s['all_live']} s, "
            f"worker {down} down {inner_s['worker_down']} s; step_seconds "
            f"{hist['step_seconds']:.3f} s (the rejoin probe's float64 "
            f"copies in its chunk), wall {wall:.2f} s, peak "
            f"{peak:.2f} GB; launches "
            f"{ {k: v for k, v in counts.items() if v} }")
        check(all(math.isfinite(x) for x in losses),
              f"{path}: non-finite loss")
        check(hist["quorum"] == quorum and hist["sync_steps"] == sync_steps,
              f"{path}: quorum {hist['quorum']} / syncs "
              f"{hist['sync_steps']} != {quorum} / {sync_steps}")
        for key in ("fault", "quorum", "sync_steps", "gossip_syncs"):
            check(hist.get(key) == cpu.get(key), f"{path}: {key} records "
                  f"{hist.get(key)} != the CPU run's {cpu.get(key)}")
        check(len(rejoin) == 1 and [r[:2] for r in rejoin]
              == [r[:2] for r in cpu["rejoin_drift"]]
              and all(math.isfinite(x) for x in rejoin[0][2:]),
              f"{path}: rejoin records {rejoin} (CPU "
              f"{cpu.get('rejoin_drift')})")
        check(len(rel) == 1 and rel[0] <= TOL_REJOIN,
              f"{path}: the rejoin drift on the card is {rel} off float64 "
              f"CPU copies (rtol {TOL_REJOIN})")
        check(run["held_params_of_the_crash"] == [True],
              f"{path}: worker {down} moved while it was down")
        check(opt_fresh, f"{path}: worker {down}'s optimizer state is not "
              f"init after its rejoin")
        check(three_quarters, f"{path}: inner steps with worker {down} down "
              f"did not launch 3/4 of an all-live step's training kernels "
              f"({dead_steps[:1]} vs {live_steps[:1]})")
        for k in TRAIN_KERNELS + WIRE_KERNELS:
            check(counts[k] > 0, f"{path}: kernel {k} never launched on "
                  f"the main path")
        for k in GOSSIP_IDLE:
            check(counts[k] == 0, f"{path}: kernel {k} launched off its "
                  f"path")
        out["runs"][path] = run
        run["seconds"] = time.perf_counter() - t_path
        log(f"  {path}: {run['seconds']:.1f} s")
    t0 = time.perf_counter()
    out["state"] = fault_state_runs(torch, tok, ds, opt_cfg)
    out["state_seconds"] = time.perf_counter() - t0
    log(f"  faults at depth {FAULT_STATE_DEPTH}: {out['state_seconds']:.1f}"
        f" s")
    n_params = out["runs"]["faults_diloco"]["n_params"]
    reports = {}
    for method, step_s in (("diloco", diloco_step_s),
                           ("gossip", gossip_step_s)):
        dcfg = DiLoCoConfig(num_workers=K, delta_dtype="int8")
        args = (dcfg, method, n_params, GOSSIP_REPORT["steps"],
                GOSSIP_REPORT["h"], step_s, GOSSIP_SPEEDS)
        free = comm_report(*args)
        empty = comm_report(*args, faults=FaultSchedule())
        faulted = comm_report(*args, faults=FaultSchedule.from_spec(
            FAULT_REPORT_SPEC))
        reports[method] = {"fault_free": free, "faulted": faulted}
        het, fhet = free["heterogeneous"], faulted["heterogeneous"]
        pair = ""
        if "gossip" in free:
            pair = (f"; pair barriers {free['gossip']['wall_clock_s']:.4f} "
                    f"-> {faulted['gossip']['wall_clock_s']:.4f} s")
        log(f"  comm_report {method} (int8, K {K}, {GOSSIP_REPORT}, step "
            f"{step_s:.4f} s, speeds {GOSSIP_SPEEDS}, link "
            f"{free['link_bytes_per_s']:.4g} B/s): "
            f"fault-free {het['wall_clock_s']:.4f} s, "
            f"{het['total_bytes']:.0f} bytes a worker; under "
            f"{FAULT_REPORT_SPEC!r}: {fhet['wall_clock_s']:.4f} s, "
            f"{fhet['total_bytes']:.0f} bytes, retry "
            f"{fhet.get('retry_bytes')} bytes" + pair)
        check(empty == free, f"comm_report {method}: an empty schedule "
              f"changed the report")
        check(fhet.get("retry_bytes", 0) > 0 and fhet != het,
              f"comm_report {method}: the fault overlay changed nothing")
    out["comm_report"] = reports
    out["launches"] = {p: r["launches"] for p, r in out["runs"].items()}
    return out


def fault_state_runs(torch, tok, ds, opt_cfg):
    """Depth ``FAULT_STATE_DEPTH``, full width (vocab 512), H 2, batches of
    8 x 128 tokens a worker, through ``DistTrainer``, bit for bit: an
    empty schedule and ``drop:1@3`` (one attempt) against the fault-free
    DiLoCo run (K 4, int8, state and residual); K 4 with worker 3 dead
    from step 0 (f32 wire) against K 3 on workers 0-2's batches (losses,
    anchor, momentum, the live rows' parameters and optimizer states);
    ``kill@3`` with a checkpoint every 2 steps, then ``resume`` (writing
    none), against the uninterrupted run for each of ``FAULT_RESUME``
    (state, residual, losses, records); and ``min_quorum`` K with worker
    1 down from step 0, which skips every round of 4 steps and leaves the
    anchor at its init, for DiLoCo (K 2) and gossip (K 4: at K 2 gossip
    binds the DiLoCo runner), then with ``rejoin:1@2`` the skipped-round
    adoption and a full round at step 5 (records)."""
    import dataclasses
    import shutil
    import tempfile
    from repro_torch.checkpoint import list_run_checkpoints
    from repro_torch.configs import DiLoCoConfig
    from repro_torch.core import (DistTrainer, FaultSchedule, SimulatedCrash,
                                  make_strategy)
    from repro_torch.launch.train import make_model
    from repro_torch.models import init_params, lm_loss
    from repro_torch.models.transformer import flatten
    cfg = make_model("nanochat-d20", False, tok.vocab_size).with_(
        num_layers=FAULT_STATE_DEPTH)
    params = init_params(cfg, seed=0, device="cuda")
    B = GOSSIP_KW["per_worker_batch"]

    def data(k, rows=None):
        if k == 1:
            return lambda s: {n: v[None] for n, v in
                              ds.batch(s, 4 * B).items()}
        return lambda s: {n: v[:rows] for n, v in
                          ds.worker_batches(s, k, B).items()}

    def run(dcfg, steps, rows=None, spec=None, **kw):
        keep = _KeepRunner(make_strategy(dcfg))
        dt = DistTrainer(lambda p, b: lm_loss(p, b, cfg), opt_cfg, dcfg,
                         keep)
        state, hist = dt.run(
            dt.init(params), data(dcfg.num_workers if rows is None else 4,
                                  rows), steps,
            faults=None if spec is None else FaultSchedule.from_spec(spec),
            **kw)
        return state, getattr(keep.runner, "residual", None), hist

    def same(a, b, keys=("loss", "sync_steps", "frag_syncs")):
        return (tree_bits_equal(torch, a[0], b[0])
                and ((a[1] is None and b[1] is None)
                     or tree_bits_equal(torch, a[1], b[1]))
                and all(a[2].get(k) == b[2].get(k) for k in keys))

    out = {}
    k4 = DiLoCoConfig(num_workers=4, h_inner_steps=GOSSIP_KW["h"],
                      delta_dtype="int8")
    base = run(k4, 4)
    for name, spec in (("empty", ""), ("drop_one_attempt", "drop:1@3")):
        got = run(k4, 4, spec=spec)
        out[name] = same(base, got)
        log(f"  DiLoCo K 4 int8, schedule {spec!r} == no schedule, bit for "
            f"bit: {out[name]}; quorum {got[2].get('quorum')}")
        check(out[name], f"schedule {spec!r} changed the fault-free run")
        del got
    del base
    f32 = dataclasses.replace(k4, delta_dtype="float32")
    a = run(f32, 4, rows=4, spec="crash:3@0")
    b = run(dataclasses.replace(f32, num_workers=3), 4, rows=3)
    sa, sb = a[0], b[0]
    out["one_dead_is_k3"] = (
        a[2]["loss"] == b[2]["loss"]
        and tree_bits_equal(torch, sa.global_params, sb.global_params)
        and tree_bits_equal(torch, sa.outer.v, sb.outer.v)
        and tree_bits_equal(torch, sa.worker_params[:3], sb.worker_params)
        and tree_bits_equal(torch, sa.inner_opt[:3], sb.inner_opt)
        and tree_bits_equal(torch, sa.worker_params[3], flatten(params)))
    log(f"  DiLoCo K 4 f32 with worker 3 dead from step 0 == K 3 on workers "
        f"0-2's batches (losses, anchor, momentum, live rows; the dead row "
        f"at init), bit for bit: {out['one_dead_is_k3']}; quorum "
        f"{a[2]['quorum']}")
    check(out["one_dead_is_k3"], "one dead worker differs from the K 3 "
          "fleet of the others")
    del a, b, sa, sb
    root = ROOT / "build"
    root.mkdir(exist_ok=True)
    for path, dkw, k, spec in FAULT_RESUME:
        dcfg = DiLoCoConfig(num_workers=k, **{"h_inner_steps":
                                              GOSSIP_KW["h"], **dkw})
        d = tempfile.mkdtemp(prefix="fault_resume_", dir=root)
        t0 = time.perf_counter()
        try:
            want = run(dcfg, 6, spec=spec or None)
            killed = None
            try:
                run(dcfg, 6, spec=",".join(x for x in (spec, "kill@3") if x),
                    checkpoint_dir=d, checkpoint_every=2)
            except SimulatedCrash as e:
                killed = str(e)
            written = [st for st, _ in list_run_checkpoints(d)]
            got = run(dcfg, 6, spec=spec or None, checkpoint_dir=d,
                      resume=True)
            ok = killed is not None and bool(written) and same(
                want, got, ("loss", "sync_steps", "frag_syncs", "fault",
                            "quorum", "rejoin_drift"))
            out[f"resume_{path}"] = {"killed": killed, "checkpoints":
                                     written, "bits_equal": ok}
            log(f"  {path} K {k} {spec!r}: kill@3 ({killed}), checkpoints "
                f"{written}, resumed == uninterrupted bit for bit: {ok}; "
                f"{time.perf_counter() - t0:.1f} s")
            check(ok, f"{path}: kill -> resume differs from the "
                  f"uninterrupted run")
            del want, got
        finally:
            shutil.rmtree(d, ignore_errors=True)
    init = flatten(params)
    for strategy, k in (("diloco", 2), ("gossip", 4)):
        dcfg = DiLoCoConfig(num_workers=k, h_inner_steps=GOSSIP_KW["h"],
                            strategy=strategy)
        st, _, hist = run(dcfg, 4, spec="crash:1@0", min_quorum=k)
        skipped = (hist["sync_steps"] == [] and hist["quorum_skip"]
                   == [1, 3] and tree_bits_equal(torch, st.global_params,
                                                 init))
        _, _, hist2 = run(dcfg, 6, spec="crash:1@0,rejoin:1@2", min_quorum=k)
        adopted = (hist2["quorum_skip"] == [1, 3]
                   and hist2["sync_steps"] == [5]
                   and [r[:2] for r in hist2["rejoin_drift"]] == [(3, 1)])
        out[f"min_quorum_{strategy}"] = {"skipped_at_init": skipped,
                                         "rejoin_adopted": adopted}
        log(f"  {strategy} K {k}, min_quorum {k}, crash:1@0: every round "
            f"skipped, anchor at init bit for bit: {skipped}; with "
            f"rejoin:1@2: skips {hist2['quorum_skip']}, syncs "
            f"{hist2['sync_steps']}, rejoin {hist2['rejoin_drift']}: "
            f"{adopted}")
        check(skipped and adopted, f"{strategy}: the min_quorum skip or "
              f"the skipped-round adoption went wrong")
        del st
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Phase 6e: GRPO
# ---------------------------------------------------------------------------

# nanochat-d20 at full width and depth (vocab 512, the tokenizer's, so the
# rollouts decode), 16 arithmetic prompts x G 8 sampled requests of 6 new
# tokens, the reference example's optimizer (constant, lr 0.01, adam_lr
# 1e-3) with fused AdamW.  At random init ``arith_reward_fn`` gives every
# group 0 (every advantage 0), so the reward is the reference test's kind:
# 1 when the first completion token lies in GRPO_REWARD_IDS (128 of the
# 512 ids: at a near-uniform policy 90% of the groups are mixed)
GRPO_ITERS = 4
GRPO_KW = dict(group_size=8, max_new=6)
GRPO_PROMPTS = 16
# the prompts whose iteration-1 groups a fresh engine rolls out again
GRPO_FRESH_PROMPTS = 2
GRPO_REWARD_IDS = frozenset(range(0, 512, 4))
GRPO_ROLLOUT_KERNELS = ("rmsnorm", "rmsnorm_residual", "paged_decode")
GRPO_UPDATE_KERNELS = ("rmsnorm", "rmsnorm_residual", "flash_fwd",
                       "flash_bwd", "rmsnorm_bwd", "fused_adamw")


class _GRPOProbe:
    """The reward function of one GRPO run: rewards a first token in
    ``GRPO_REWARD_IDS`` and records, per ``rollout_and_step`` call, the
    sampled rows, the time and the launch counts at its first call (the
    rollouts are then done: ``generate_ids`` has read the tokens back)."""

    def __init__(self):
        self.rows, self.marks = [], []

    def begin(self):
        self.rows.append([])

    def __call__(self, prompt_idx, row):
        from repro_torch.kernels import KERNELS, launches
        if not self.rows[-1]:
            self.marks.append((time.perf_counter(),
                               {k: launches[k] for k in KERNELS}))
        self.rows[-1].append([int(t) for t in row])
        return 1.0 if int(row[0]) in GRPO_REWARD_IDS else 0.0


def grpo_p_set(torch, cfg, params, prompts):
    """Mean over the prompts of the policy's probability of the reward set
    at the prompt's last position (one right-padded forward)."""
    from repro_torch.models import forward_lm
    toks = torch.zeros((len(prompts), max(map(len, prompts))),
                       dtype=torch.int32)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = torch.tensor(p)
    last = torch.tensor([len(p) - 1 for p in prompts])
    with torch.no_grad():
        logits, _ = forward_lm(params, {"tokens": toks.cuda()}, cfg)
    probs = torch.softmax(logits[torch.arange(len(prompts)), last.cuda()]
                          .float(), dim=-1)
    ids = torch.tensor(sorted(GRPO_REWARD_IDS), device="cuda")
    return float(probs[:, ids].sum(-1).mean())


def grpo_run(torch, cfg, params, prompts, pad_id, opt_cfg, iters,
             profiled=False, fresh_check=False):
    """``iters`` iterations of ``GRPOTrainer.rollout_and_step`` (seed = the
    iteration) from ``params``, launch counts reset before each.  Returns
    (state, per-iteration records, the sampled rows per iteration, the
    fresh engine's rows, a copy of the parameters after iteration 0).
    ``profiled``: each iteration under torch.profiler (its device busy
    share, and the seconds the trace took to process); ``fresh_check``:
    before iteration 1, a fresh ``Engine`` on the current parameters
    samples iteration 1's seed for the first ``GRPO_FRESH_PROMPTS``
    prompts' groups (a request's tokens depend on its seed, id and
    prompt alone, not on the batch it shares)."""
    from repro_torch import Engine
    from repro_torch.core import GRPOTrainer
    from repro_torch.kernels import KERNELS, launches, reset_launches
    from repro_torch.models.transformer import flatten
    from torch.profiler import ProfilerActivity, profile
    tr = GRPOTrainer(cfg, opt_cfg, **GRPO_KW)
    state = tr.init(params)
    probe = _GRPOProbe()
    G, max_new = GRPO_KW["group_size"], GRPO_KW["max_new"]
    rep = [p for p in prompts for _ in range(G)]
    recs, fresh, snap = [], None, None
    for it in range(iters):
        if fresh_check and it == 1:
            eng = Engine(cfg, state["params"], device="cuda")
            fresh = eng.generate_ids(rep[:G * GRPO_FRESH_PROMPTS],
                                     max_new=max_new, greedy=False,
                                     temperature=tr.temperature,
                                     seed=it).tolist()
            del eng
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        probe.begin()
        reset_launches()
        prof = (profile(activities=[ProfilerActivity.CUDA]) if profiled
                else None)
        if prof is not None:
            prof.__enter__()
        t0 = time.perf_counter()
        state, loss, mean_r = tr.rollout_and_step(state, prompts, probe,
                                                  pad_id=pad_id, seed=it)
        t1 = time.perf_counter()
        t_mark, at_mark = probe.marks[-1]
        total = {k: launches[k] for k in KERNELS}
        rec = {"loss": loss, "mean_reward": mean_r,
               "rollout_s": t_mark - t0, "update_s": t1 - t_mark,
               "sampled_tokens_per_s": len(rep) * max_new / (t_mark - t0),
               "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
               "rollout_launches": at_mark,
               "update_launches": {k: total[k] - at_mark[k]
                                   for k in KERNELS}}
        if prof is not None:
            t2 = time.perf_counter()
            prof.__exit__(None, None, None)
            busy = sum(device_time_by_kernel(torch, prof).values()) / 1e6
            rec["busy_share"] = busy / (t1 - t0) if busy else None
            rec["trace_processing_s"] = time.perf_counter() - t2
            del prof
        recs.append(rec)
        if it == 0:
            snap = {k: v.clone() for k, v in flatten(state["params"]).items()}
    return state, recs, probe.rows, fresh, snap


def phase_grpo(torch):
    """GRPO at nanochat-d20's full width (``GRPO_*``): run A (timed, 4
    iterations), then run B from the same seed (1 iteration, under
    torch.profiler).  Gates: (a) the mean probability of the reward set
    at the prompts' last position rises over run A; (b) run B's rollouts
    and parameters equal run A's after iteration 0, bit for bit; (c)
    iteration 1's rollouts of the first ``GRPO_FRESH_PROMPTS`` prompts
    equal a fresh ``Engine``'s on the parameters iteration 0 left, with
    its seed; (d) at depth 2, one
    update on injected completions, card against CPU, within phase 3's
    training-step gates (``grpo_update_vs_cpu``); (e) the rollouts
    launch the norms and paged decode and no other kernel, the update the
    training kernels and no other."""
    from repro_torch.configs import NANOCHAT_D20, OptimizerConfig
    from repro_torch.data import build_tokenizer, synthetic
    from repro_torch.kernels import KERNELS
    from repro_torch.models import init_params
    from repro_torch.models.transformer import flatten
    tok = build_tokenizer()
    cfg = NANOCHAT_D20.with_(vocab_size=tok.vocab_size)
    items = synthetic.gen_arith_eval(GRPO_PROMPTS, seed=31)
    prompts = [tok.encode(it["prompt"]) for it in items]
    opt_cfg = OptimizerConfig(total_steps=GRPO_ITERS, warmup_steps=0,
                              schedule="constant", learning_rate=0.01,
                              adam_lr=1e-3, fused_adamw=True)
    params = init_params(cfg, seed=0, device="cuda")
    p_before = grpo_p_set(torch, cfg, params, prompts)
    state_a, recs, rows_a, fresh, snap_a = grpo_run(
        torch, cfg, params, prompts, tok.pad, opt_cfg, GRPO_ITERS,
        fresh_check=True)
    p_after = grpo_p_set(torch, cfg, state_a["params"], prompts)
    del state_a
    for it, r in enumerate(recs):
        log(f"  GRPO iter {it}: loss {r['loss']:+.6f} mean_reward "
            f"{r['mean_reward']:.4f}, rollout {r['rollout_s']:.3f} s "
            f"({r['sampled_tokens_per_s']:.1f} sampled tokens/s), update "
            f"{r['update_s']:.3f} s, peak {r['peak_memory_gb']:.2f} GB")
    state_b, recs_b, rows_b, _, snap_b = grpo_run(
        torch, cfg, params, prompts, tok.pad, opt_cfg, 1, profiled=True)
    same_params = tree_bits_equal(torch, snap_a, snap_b)
    for it, r in enumerate(recs_b):
        log(f"  GRPO run B iter {it} under torch.profiler: rollout "
            f"{r['rollout_s']:.3f} s, update {r['update_s']:.3f} s, device "
            f"busy share {r['busy_share'] or 'not measured'} (trace "
            f"processed in {r['trace_processing_s']:.1f} s)")
    log(f"  GRPO P(reward set) at the prompts' last position {p_before:.6f}"
        f" -> {p_after:.6f}; run B == run A after iteration 0: rollouts "
        f"{rows_b == rows_a[:1]}, parameters {same_params}; iteration 1's "
        f"first {len(fresh)} rows == a fresh engine's "
        f"{fresh == rows_a[1][:len(fresh)]}")
    check(p_after > p_before, "GRPO did not raise the reward set's "
          "probability")
    check(rows_b == rows_a[:1] and same_params, "GRPO: a second run from "
          "the same seed differs")
    check(fresh == rows_a[1][:len(fresh)], "GRPO: iteration 1 did not roll "
          "out with the updated parameters")
    for it, r in enumerate(recs):
        for part, need in (("rollout", GRPO_ROLLOUT_KERNELS),
                           ("update", GRPO_UPDATE_KERNELS)):
            counts = r[f"{part}_launches"]
            for k in KERNELS:
                check((counts[k] > 0) == (k in need), f"GRPO iter {it} "
                      f"{part}: kernel {k} launched {counts[k]} times")
    del state_b, snap_a, snap_b, params
    torch.cuda.empty_cache()
    return {"iterations": recs, "profiled": recs_b,
            "p_reward_set": [p_before, p_after],
            "launches": {
                "grpo_rollout": {k: sum(r["rollout_launches"][k]
                                        for r in recs) for k in KERNELS},
                "grpo_update": {k: sum(r["update_launches"][k]
                                       for r in recs) for k in KERNELS}},
            "vs_cpu": grpo_update_vs_cpu(torch, cfg, prompts, tok.pad,
                                         opt_cfg)}


def grpo_update_vs_cpu(torch, cfg, prompts, pad_id, opt_cfg):
    """One GRPO update of ``cfg`` at depth 2 on injected completions
    (random rows from a seed, the reward set's rewards, the batch
    ``rollout_batch`` builds), card against CPU from the same
    parameters, within phase 3's training-step gates: ``grpo_loss``
    (rtol 1e-5), its gradients (each leaf 1e-4 of its max) and the
    optimizer's update from the CPU's gradients (``update_vs_cpu``)."""
    import numpy as np
    from repro_torch.core import grpo_loss
    from repro_torch.core.grpo import rollout_batch
    from repro_torch.models import init_params
    from repro_torch.models.transformer import flatten, unflatten
    cfg = cfg.with_(num_layers=2)
    G, max_new = GRPO_KW["group_size"], GRPO_KW["max_new"]
    rep = [p for p in prompts for _ in range(G)]
    rows = np.random.default_rng(17).integers(
        0, cfg.vocab_size, (len(rep), max_new)).astype(np.int32)
    rewards = np.asarray([1.0 if int(r[0]) in GRPO_REWARD_IDS else 0.0
                          for r in rows], np.float32)
    batch = {k: torch.from_numpy(v) for k, v in rollout_batch(
        rep, rows, rewards, G, max_new, pad_id).items()}
    params = flatten(init_params(cfg, seed=0, device="cpu"))
    params_d = {k: v.cuda() for k, v in params.items()}
    l_cpu, l_gpu, e_grad, g_cpu = loss_grads_vs_cpu(
        torch, lambda p, b: grpo_loss(p, b, cfg), params, params_d, batch)
    e_loss = abs(l_gpu - l_cpu) / abs(l_cpu)
    # the loss sums adv * logprob over zero-mean advantages, so it cancels
    # to far below its terms: its error is taken relative to their scale,
    # mean |adv| * |mean log-prob|, not to the loss
    with torch.no_grad():
        _, met = grpo_loss(unflatten(params), batch, cfg)
    scale = float(batch["adv"].abs().mean()) * abs(float(
        met["mean_logprob"]))
    e_terms = abs(l_gpu - l_cpu) / scale
    log(f"  GRPO at depth 2, {len(rep)} injected completions: loss "
        f"{l_gpu:+.6f}, error {e_terms:.2e} of its terms' scale {scale:.4f} "
        f"(tol 1e-5; {e_loss:.2e} of the loss itself), worst gradient leaf "
        f"{e_grad:.2e} of its max (tol 1e-4)")
    check(e_terms <= 1e-5 and e_grad <= 1e-4,
          "GRPO loss or gradients on the card disagree with the CPU")
    e_upd = update_vs_cpu(torch, opt_cfg, params, params_d, g_cpu, "GRPO")
    return {"loss_rel": e_loss, "loss_rel_terms": e_terms, "grad_rel": e_grad,
            "update_rel": e_upd}


# ---------------------------------------------------------------------------
# Phase 7: timing
# ---------------------------------------------------------------------------

def time_ms(torch, fn, reps=50):
    """Mean device ms of fn() with the L2 cache flushed before each call
    (the main path finds these operands cold: other layers' weights and
    KV pass through L2 between two calls of one layer).  A sleep kernel
    ahead of each timed call keeps the card busy while the host enqueues
    it, so the host's launch overhead stays outside the events."""
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for a, b in ev:
        flush.zero_()
        torch.cuda._sleep(2_000_000)          # ~1 ms at 1.98 GHz
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in ev) / reps


def bound(nbytes, ops, dtype):
    """(ms, "bytes" or "operations"): the larger of bytes over HBM's rate
    and ops over the peak rate of ``dtype`` (a PEAK_OPS_PER_S key)."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def tc_bounds(name, nbytes, ops):
    """The tensor-core rows' bound and roofs, ms: ``bound_ms`` (and
    ``bound_by``), the function's ``ops`` at the tensor cores' rate for
    their operand type (``TC_OPS_BY_TYPE``) or its bytes over HBM's
    rate; ``roof_split_tf32_ms``, the ceiling of the split the kernels
    chose (``TC_TF32_PRODUCTS`` TF32 products per f32 product); and
    ``bound_ms_f32``, the 67 TFLOP/s f32 roof without tensor cores."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = sum(ops * share / PEAK_OPS_PER_S[t]
                for t, share in TC_OPS_BY_TYPE[name].items())
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "roof_split_tf32_ms": bound(
                nbytes, TC_TF32_PRODUCTS[name] * ops, "tf32")[0],
            "bound_ms_f32": bound(nbytes, ops, "float32")[0]}


def with_bound(t, dtype):
    """A timing dict ({"ms", "plain_ms", "library_ms", "nbytes", "ops",
    ...}) with its ``bound_ms`` and ``bound_by`` in place of the counts."""
    t = dict(t)
    b_ms, b_by = bound(t.pop("nbytes"), t.pop("ops"), dtype)
    return dict(t, bound_ms=b_ms, bound_by=b_by)


def with_tc_bound(t, name):
    """``with_bound`` for a tensor-core kernel: ``tc_bounds``' bound and
    roofs in place of the counts."""
    t = dict(t)
    return dict(t, **tc_bounds(name, t.pop("nbytes"), t.pop("ops")))


def norm_fwd_times(torch, shape, seed):
    """{"rmsnorm": ..., "rmsnorm_residual": ...} at ``shape`` (f32): the
    kernel's, the plain version's and ``F.rms_norm``'s ms (the residual
    variant has no one-call counterpart), with the function's bytes (x
    read and the output written once, plus the residual read and the new
    residual written; the scale read once) and operations."""
    import torch.nn.functional as F
    from repro_torch.kernels.rmsnorm import (rmsnorm, rmsnorm_plain,
                                             rmsnorm_residual,
                                             rmsnorm_residual_plain)
    g = torch.Generator().manual_seed(40 + seed)
    x, r = (torch.randn(shape, generator=g).cuda() for _ in range(2))
    d = shape[-1]
    sc = (1 + 0.1 * torch.randn(d, generator=g)).cuda()
    n = x.numel()
    return {
        "rmsnorm": {
            "shape": list(shape), "ms": time_ms(torch, lambda: rmsnorm(x, sc)),
            "plain_ms": time_ms(torch, lambda: rmsnorm_plain(x, sc)),
            "library_ms": time_ms(
                torch, lambda: F.rms_norm(x, (d,), sc, 1e-5)),
            "nbytes": 2 * n * 4 + d * 4, "ops": 4 * n},
        "rmsnorm_residual": {
            "shape": list(shape),
            "ms": time_ms(torch, lambda: rmsnorm_residual(x, r, sc)),
            "plain_ms": time_ms(
                torch, lambda: rmsnorm_residual_plain(x, r, sc)),
            "library_ms": None, "nbytes": 4 * n * 4 + d * 4, "ops": 5 * n}}


def paged_timing(torch, T, **case):
    """Paged decode (T 1) or verify (T 5) at ``paged_case``'s shape (f32;
    ``case``: its KV, G, D), the plain version and the SDPA yardstick:
    {"shape", "ms", "plain_ms", "library_ms", "nbytes", "ops"}; bytes and
    operations of what this call's data needs (``paged_work``)."""
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import (
        paged_decode_attention, paged_decode_attention_plain,
        paged_verify_attention, paged_verify_attention_plain)
    dev = torch.device("cuda")
    item = 4
    q, kp, vp, tab, start, ntok, live = (
        t.to(dev) for t in paged_case(torch, T=T, dtype="float32", seed=T,
                                      **case))
    S, KV, G, D = q.shape[0], q.shape[-3], q.shape[-2], q.shape[-1]
    bs, MB = kp.shape[1], tab.shape[1]
    kv_rows, q_rows, tab_reads, pairs = paged_work(tab, start, ntok, bs)
    nbytes = ((2 * kv_rows * KV * D + 2 * q_rows * KV * G * D) * item
              + (tab_reads + S * (1 if T == 1 else 2)) * 4)
    ops = 4 * pairs * KV * G * D
    # library yardstick: SDPA over the gathered KV with a boolean mask
    L = MB * bs
    safe = tab.clamp(min=0).long()
    kg = kp[safe].reshape(S, L, KV, D).transpose(1, 2)
    vg = vp[safe].reshape(S, L, KV, D).transpose(1, 2)
    kg = kg.repeat_interleave(G, dim=1).contiguous()
    vg = vg.repeat_interleave(G, dim=1).contiguous()
    tq = torch.arange(T, device=dev)
    qpos = start.long()[:, None] + tq[None, :]
    mapped = (tab >= 0).repeat_interleave(bs, dim=1)
    mask = ((torch.arange(L, device=dev)[None, None, :]
             <= qpos[:, :, None]) & mapped[:, None, :])[:, None]
    mask = mask | ~mask.any(-1, keepdim=True)      # no empty rows
    if T == 1:
        qs = q.reshape(S, KV * G, 1, D)
        fn = lambda: paged_decode_attention(q, kp, vp, tab, start)
        plain = lambda: paged_decode_attention_plain(q, kp, vp, tab, start)
    else:
        qs = q.permute(0, 2, 3, 1, 4).reshape(S, KV * G, T, D)
        fn = lambda: paged_verify_attention(q, kp, vp, tab, start, ntok)
        plain = lambda: paged_verify_attention_plain(q, kp, vp, tab, start,
                                                     ntok)
    lib = lambda: F.scaled_dot_product_attention(qs, kg, vg, attn_mask=mask)
    return {"shape": list(q.shape), "ms": time_ms(torch, fn),
            "plain_ms": time_ms(torch, plain),
            "library_ms": time_ms(torch, lib), "nbytes": nbytes, "ops": ops}


def phase_timing(torch, paths, checks):
    """``paths``: {main-path run name: {kernel: launches}}."""
    dtype = "float32"                     # the main path's working type
    out = []

    def row(name, shape, ms, plain_ms, lib_ms, nbytes, ops, **extra):
        b_ms, b_by = bound(nbytes, ops, dtype)
        if name in TC_OPS_BY_TYPE:               # tensor-core route
            fb = tc_bounds(name, nbytes, ops)
            b_ms, b_by = fb.pop("bound_ms"), fb.pop("bound_by")
            extra = dict(extra, **fb, bound_rates={
                t: f"{share:g} of the FLOPs at "
                   f"{PEAK_OPS_PER_S[t] / 1e12:.0f} TFLOP/s"
                for t, share in TC_OPS_BY_TYPE[name].items()})
        mine = [c for c in checks if c[0] == name]
        err = {dt: max((c[3] for c in mine if c[1] == dt), default=None)
               for dt in ("float32", "bfloat16")}
        gate = {dt: max((c[5] for c in mine if c[1] == dt
                         and c[5] is not None), default=None)
                for dt in ("float32", "bfloat16")}
        out.append(dict({"name": name, "route": "cuda",
                         "source": SOURCE[name], "replaces": REPLACES[name],
                         "launches": sum(c[name] for c in paths.values()),
                         "launches_by_path": {k: c[name]
                                              for k, c in paths.items()},
                         "max_abs_err": err[dtype], "ms": ms,
                         "plain_ms": plain_ms, "bound_ms": b_ms,
                         "bound_by": b_by, "library_ms": lib_ms,
                         "dtype": dtype, "shape": list(shape),
                         "max_abs_err_bf16": err["bfloat16"],
                         "worst_gate_ratio": gate}, **extra,
                        **({"gradient_of": GRADIENT_OF[name]}
                           if name in GRADIENT_OF else {})))

    norms = {k: norm_fwd_times(torch, shape, seed)
             for seed, (k, shape) in enumerate(NORM_SHAPES.items())}
    libraries = {"rmsnorm": "F.rms_norm",
                 "rmsnorm_residual": "null: no one PyTorch call adds the "
                                     "residual and normalises"}
    for name, library in libraries.items():
        t = norms["decode"][name]
        row(name, NORM_SHAPES["decode"], t["ms"], t["plain_ms"],
            t["library_ms"], t["nbytes"], t["ops"], library=library,
            **{f"at_{k}_shape": with_bound(v[name], dtype)
               for k, v in norms.items() if k != "decode"})

    for name, T in (("paged_decode", 1), ("paged_verify", 5)):
        t = paged_timing(torch, T)
        at = {}
        for KV, G, D in ARCH_PAGED_CASES:
            a = paged_timing(torch, T, KV=KV, G=G, D=D)
            at[f"at_kv{KV}_g{G}_d{D}_shape"] = with_bound(a, dtype)
        row(name, t["shape"], t["ms"], t["plain_ms"], t["library_ms"],
            t["nbytes"], t["ops"],
            library="F.scaled_dot_product_attention over the K/V gathered "
                    "from the pool, with a boolean mask", **at)
    static_rows(torch, row)
    quant_rows(torch, row)
    train_rows(torch, row)
    wire_rows(torch, row)
    return out


# key positions per CTA tried at a full cache (the kernels run the
# wrapper's CHUNK_KEYS; the other values are set for this sweep only)
CHUNK_SWEEP = (32, 64, 128, 256)


def phase_split_timing(torch):
    """Paged verify (T 5, f32) and the ring decode at a full cache, every
    slot at 486 or more keys (S 8, KV 10, G 1, D 128, bs 16, MB 32; a
    ring of 512 live slots at B 8), where the split matters most, and at
    phase 7's shapes; for each chunk size of ``CHUNK_SWEEP`` (CUDA events,
    L2 flushed), each output checked against the plain version.  Returns
    {case: {chunk_keys: ms}} plus the full-cache byte bounds, and at the
    wrapper's chunk size the device time of the split and the combine
    kernel per launch (``split_breakdown``; also for paged decode and for
    a decode call with no active slot)."""
    from repro_torch.kernels.decode_attention import ops as da
    dev = torch.device("cuda")
    cap = 32 * 16
    q, kp, vp, tab, start, ntok, live = (t.to(dev) for t in paged_case(
        torch, T=5, seed=5, starts=[cap - 5 - 3 * i for i in range(8)]))
    kv_rows, q_rows, tab_reads, _ = paged_work(tab, start, ntok, 16)
    verify_bytes = (2 * kv_rows * 10 * 128 + 2 * q_rows * 10 * 128) * 4 + (
        tab_reads + 16) * 4
    p7 = [t.to(dev) for t in paged_case(torch, T=5, seed=5)]
    B, KV, G, Sr, D = 8, 10, 1, cap, 128
    g = torch.Generator().manual_seed(9)
    rq, rk, rv = (torch.randn(shape, generator=g).to(dev) for shape in (
        (B, KV, G, D), (B, KV, Sr, D), (B, KV, Sr, D)))
    r_qpos = torch.full((B,), 600, dtype=torch.int32, device=dev)
    r_pos = (599 - torch.arange(Sr, device=dev, dtype=torch.int32))[None] \
        .repeat(B, 1).contiguous()
    ring_bytes = (2 * B * Sr * KV * D + 2 * B * KV * G * D) * 4 + (
        B * Sr + B) * 4
    r7 = ring_case(torch, *RING_CASE)
    full = (q, kp, vp, tab, start, ntok)
    ring = (rq, rk, rv, r_pos, r_qpos)
    # name: (kernel call, plain call, rows compared)
    cases = {
        "paged_verify_full": (lambda: da.paged_verify_attention(*full),
                              lambda: da.paged_verify_attention_plain(*full),
                              live),
        "paged_verify_phase7": (lambda: da.paged_verify_attention(*p7[:6]),
                                lambda: da.paged_verify_attention_plain(
                                    *p7[:6]), p7[6]),
        "ring_decode_full": (lambda: da.decode_attention(*ring),
                             lambda: da.decode_attention_plain(*ring), None),
        "ring_decode_phase7": (lambda: da.decode_attention(*r7[:5]),
                               lambda: da.decode_attention_plain(*r7[:5]),
                               r7[5]),
    }
    d7 = [t.to(dev) for t in paged_case(torch, T=1, seed=1)]
    idle = torch.full_like(d7[4], -1)
    calls = {"paged_decode_phase7": lambda: da.paged_decode_attention(*d7[:5]),
             "paged_decode_no_active_slot": lambda: da.paged_decode_attention(
                 *d7[:4], idle)}
    calls.update({name: fn for name, (fn, _, _) in cases.items()})
    out = {name: {} for name in cases}
    out["device_us"] = split_breakdown(torch, calls)
    default = da.CHUNK_KEYS
    try:
        for ck in CHUNK_SWEEP:
            da.CHUNK_KEYS = ck
            for name, (fn, plain, mask) in cases.items():
                err, ok, _ = max_err(torch, fn(), plain(), mask)
                check(ok, f"{name} at CHUNK_KEYS {ck} disagrees with its "
                      f"plain version ({err:.3e})")
                out[name][ck] = time_ms(torch, fn)
    finally:
        da.CHUNK_KEYS = default
    out["chunk_keys"] = default
    out["bound_ms"] = {"paged_verify_full": verify_bytes / HBM_BYTES_PER_S
                       * 1e3,
                       "ring_decode_full": ring_bytes / HBM_BYTES_PER_S * 1e3}
    return out


def split_breakdown(torch, calls):
    """{call: {"split": us, "combine": us}}: device microseconds per
    launch of the split kernel and of the combine kernel, averaged over
    the launches the trace recorded (torch.profiler over 10 calls, each
    after an L2 flush and a sleep kernel, as ``time_ms``; None where the
    trace recorded none)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device="cuda")
    out = {}
    for name, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                flush.zero_()
                torch.cuda._sleep(2_000_000)
                fn()
            torch.cuda.synchronize()
        us = {"split": 0.0, "combine": 0.0}
        n = {"split": 0, "combine": 0}
        for e in prof.key_averages():
            part = next((p for p in us if f"{p}_kernel" in e.key), None)
            if part is None or e.device_type != DeviceType.CUDA:
                continue
            t = getattr(e, "self_device_time_total", None)
            us[part] += e.self_cuda_time_total if t is None else t
            n[part] += e.count
        out[name] = {p: us[p] / n[p] if n[p] else None for p in us}
    return out


def paged_work(tab, start, ntok, bs):
    """What one paged call's data needs (window 0): the K/V rows at a
    mapped position <= the slot's last query (each read once), the query
    rows that attend some key, the table entries up to the last query's
    block, and the (query, key) pairs.  Returns (kv_rows, q_rows,
    tab_reads, pairs) per KV head."""
    kv_rows, pairs, q_rows, tab_reads = 0, 0, 0, 0
    tab_h, start_h, ntok_h = tab.cpu(), start.cpu(), ntok.cpu()
    for s in range(tab_h.shape[0]):
        st, n = int(start_h[s]), int(ntok_h[s])
        if st < 0 or n == 0:
            continue
        last = st + n - 1
        mapped = [int(tab_h[s, p // bs]) >= 0 for p in range(last + 1)]
        kv_rows += sum(mapped)
        tab_reads += last // bs + 1
        for t in range(n):
            keys = sum(mapped[:st + t + 1])
            pairs += keys
            q_rows += keys > 0
    return kv_rows, q_rows, tab_reads, pairs


def ssd_ops(B, S, H, P, N, Q):
    """FLOPs the chunked scan needs: per chunk of r real rows, per batch
    row the causal half of C.B^T (r(r+1)/2 pairs of N), and per head the
    inter term and the state update (2 r N P each) and the intra product
    (r(r+1)/2 pairs of P), two FLOPs a multiply-add."""
    ops = 0
    for c0 in range(0, S, Q):
        r = min(Q, S - c0)
        pairs = r * (r + 1) // 2
        ops += 2 * pairs * N + H * (4 * r * N * P + 2 * pairs * P)
    return B * ops


def ssd_times(torch, shape):
    """The SSD kernel's and its plain version's ms at ``shape`` (B, S, H,
    P, N, Q), f32, with the function's bytes (x and y, dt, A, D, B and C
    once, the final state written) and operations (``ssd_ops``)."""
    from repro_torch.kernels.ssd import ssd, ssd_chunked
    B, S, H, P, N, Q = shape
    args = ssd_case(torch, B, S, H, P, N, seed=S)
    return {"shape": list(shape),
            "ms": time_ms(torch, lambda: ssd(*args, chunk=Q), reps=20),
            "plain_ms": time_ms(torch, lambda: ssd_chunked(*args, chunk=Q),
                                reps=5),
            "library_ms": None,
            "nbytes": (2 * B * S * H * P + B * S * H + 2 * H + 2 * B * S * N
                       + B * H * N * P) * 4,
            "ops": ssd_ops(B, S, H, P, N, Q)}


def static_rows(torch, row):
    """Timing rows of the SSD scan at mamba2-1.3b's shapes
    (``SSD_TIMING_SHAPES``: the row at B 2, S 512, H 64, P 64, N 128, Q
    128, and scoring's B 4, S 144 beside it) and of the ring decode at
    (B 8, KV 10, G 1, S 320, D 128), f32.  The SSD's bytes and operations
    are ``ssd_times``'.  The ring's bytes: the live K/V rows, q, the
    output and the positions; 4 FLOPs per (query head, live slot, d).  No
    one PyTorch call computes the chunked scan (library_ms null); the
    ring's yardstick is SDPA with the slots' boolean mask."""
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import (decode_attention,
                                                      decode_attention_plain)
    t = {k: ssd_times(torch, shape) for k, shape in SSD_TIMING_SHAPES.items()}
    row("ssd", t["timed"]["shape"], t["timed"]["ms"], t["timed"]["plain_ms"],
        None, t["timed"]["nbytes"], t["timed"]["ops"],
        library="null: no single PyTorch call computes the chunked SSD "
                "scan", at_scoring_shape=with_tc_bound(t["scoring"], "ssd"))
    q, k, v, pos, q_pos, live = ring_case(torch, *RING_CASE)
    Bq, KV, G, D = q.shape
    Sr = k.shape[2]
    ok = (pos >= 0) & (pos <= q_pos[:, None].long())
    n_live = int(ok.sum())
    nbytes = (2 * n_live * KV * D + 2 * Bq * KV * G * D) * 4 + (
        Bq * Sr + Bq) * 4
    mask = ok[:, None, None, :]
    mask = mask | ~mask.any(-1, keepdim=True)          # no empty rows
    qs = q.reshape(Bq, KV * G, 1, D)
    row("ring_decode", tuple(q.shape) + (Sr,),
        time_ms(torch, lambda: decode_attention(q, k, v, pos, q_pos)),
        time_ms(torch, lambda: decode_attention_plain(q, k, v, pos, q_pos)),
        time_ms(torch, lambda: F.scaled_dot_product_attention(
            qs, k, v, attn_mask=mask)),
        nbytes, 4 * n_live * KV * G * D, live_slots=n_live,
        library="F.scaled_dot_product_attention over the ring with the "
                "slots' boolean mask")
    del q, k, v, pos, q_pos, mask


def quant_rows(torch, row):
    """Timing rows of the quantized-pool and fp8 QK^T variants at the
    main path's paged shapes and f32 queries: the dequant kernels on an
    fp8_e4m3 pool (int8 and fp8_e5m2 beside it), the fp8 kernels on an
    f32 pool.  No single PyTorch call dequantizes a paged pool and
    attends, or attends with an fp8 QK^T, so library_ms is null."""
    from repro_torch.kernels import decode_attention as da
    dev = torch.device("cuda")
    for step, T in (("decode", 1), ("verify", 5)):
        q, kp, vp, tab, start, ntok, _ = (
            t.to(dev) for t in paged_case(torch, T=T, seed=T))
        S, KV, G, D = q.shape[0], q.shape[-3], q.shape[-2], q.shape[-1]
        bs = kp.shape[1]
        idx = (start,) if T == 1 else (start, ntok)
        kv_rows, q_rows, tab_reads, pairs = paged_work(tab, start, ntok, bs)
        small = 2 * q_rows * KV * G * D * 4 + (tab_reads + len(idx) * S) * 4
        ops = 4 * pairs * KV * G * D
        fn = getattr(da, f"paged_{step}_attention_dequant")
        plain = getattr(da, f"paged_{step}_attention_dequant_plain")
        ms, plain_ms = {}, {}
        for target in ("fp8_e4m3", "int8", "fp8_e5m2"):
            kv = with_pool(torch, kp, vp, target)
            ms[target] = time_ms(torch, lambda: fn(q, *kv, tab, *idx))
            plain_ms[target] = time_ms(torch, lambda: plain(q, *kv, tab,
                                                            *idx))
        # 1-byte payload plus one f32 scale per (token, head), K and V
        row(f"paged_{step}_dequant", q.shape, ms["fp8_e4m3"],
            plain_ms["fp8_e4m3"], None,
            2 * kv_rows * KV * (D * 1 + 4) + small, ops,
            pool="float8_e4m3fn", ms_by_pool=ms, plain_ms_by_pool=plain_ms,
            library="null: no single PyTorch call dequantizes a paged pool "
                    "and attends")
        fn = getattr(da, f"paged_{step}_attention")
        plain = getattr(da, f"paged_{step}_attention_plain")
        row(f"paged_{step}_fp8", q.shape,
            time_ms(torch, lambda: fn(q, kp, vp, tab, *idx, fp8=True)),
            time_ms(torch, lambda: plain(q, kp, vp, tab, *idx, 0, True)),
            None, 2 * kv_rows * KV * D * 4 + small, ops, pool="float32",
            device_function=QK_DOT_FP8,
            library="null: no single PyTorch call attends with a per-row "
                    "fp8 QK^T")


def flash_timing(torch, B, S, H, KV, D):
    """{name: (ms, plain_ms, library_ms, bytes, ops)} of flash_fwd,
    flash_fwd_fp8 and flash_bwd at (B, S, H, KV, D), f32, causal: the
    kernel, its plain version and one SDPA call (forward, or its backward
    through autograd) on (B, H, S, D) copies.  Bytes: q, k, v and o (and
    dO, dQ, dK, dV) once, lse once; ops: 4 B H S^2 D / 2 FLOPs forward
    (half the scores), 2.5 times that backward."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd_plain, flash_attention_fp8_plain,
        flash_attention_plain, flash_bwd, flash_fwd)
    q, k, v, do = flash_inputs(torch, B=B, S=S, H=H, KV=KV, D=D)
    o, lse = flash_fwd(q, k, v)
    qt, kt, vt, dot = (t.transpose(1, 2).contiguous() for t in (q, k, v, do))
    fwd_ops = 4 * B * H * S * S * D / 2
    act = B * S * H * D * 4
    leaves = [t.clone().requires_grad_() for t in (qt, kt, vt)]
    out_lib = F.scaled_dot_product_attention(*leaves, is_causal=True)
    sdpa = time_ms(torch, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True))
    return {
        "flash_fwd": (time_ms(torch, lambda: flash_fwd(q, k, v)),
                      time_ms(torch, lambda: flash_attention_plain(q, k, v)),
                      sdpa, 4 * act + B * H * S * 4, fwd_ops),
        # the fp8 variant's operations: the same FLOPs (its QK^T on codes)
        "flash_fwd_fp8": (time_ms(torch, lambda: flash_fwd(q, k, v,
                                                           fp8=True)),
                          time_ms(torch, lambda: flash_attention_fp8_plain(
                              q, k, v)),
                          None, 4 * act + B * H * S * 4, fwd_ops),
        "flash_bwd": (time_ms(torch, lambda: flash_bwd(q, k, v, o, lse, do)),
                      time_ms(torch, lambda: flash_attention_bwd_plain(
                          q, k, v, o, lse, do)),
                      time_ms(torch, lambda: torch.autograd.grad(
                          out_lib, leaves, dot, retain_graph=True)),
                      8 * act + B * H * S * 4, 2.5 * fwd_ops)}


def sdpa_kernels(torch, B, S, H, KV, D):
    """{"forward"/"backward": {kernel: device us per call}}: what an f32
    causal SDPA call and its backward launch at (B, S, H, KV, D) (on
    (B, H, S, D) tensors, H = KV), the yardstick of the flash rows, by
    torch.profiler over 5 calls; empty where it recorded no device time.
    Run first: profiled in phase 7, the forward recorded no device time,
    with or without a warm-up step, while the backward did."""
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile
    g = torch.Generator().manual_seed(0)
    q, k, v, do = (torch.randn((B, n, S, D), generator=g).cuda()
                   for n in (H, KV, KV, H))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = F.scaled_dot_product_attention(*leaves, is_causal=True)
    torch.autograd.grad(out, leaves, do, retain_graph=True)
    torch.cuda.synchronize()
    res = {}
    for part, fn in (("forward", lambda: F.scaled_dot_product_attention(
                          q, k, v, is_causal=True)),
                     ("backward", lambda: torch.autograd.grad(
                          out, leaves, do, retain_graph=True))):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                fn()
            torch.cuda.synchronize()
        us = device_time_by_kernel(torch, prof)
        res[part] = {n: t / 5 for n, t in sorted(us.items(),
                                                 key=lambda kv: -kv[1])}
    return res


def train_rows(torch, row):
    """Timing rows of the training kernels at the main path's shapes
    (float32): flash at (B 4, S 1024, H = KV = 10, D 128), also at the
    pipeline's (``PIPELINE_FLASH_SHAPE``) and qwen1.5-0.5b's step
    (``QWEN_FLASH_SHAPE``, head dim 64), the RMSNorm
    backward, plain and residual, at 4 x 1024 and 8 x 128 rows of 1280,
    fused AdamW on the AdamW partition's largest leaf (65536 x 1280)."""
    from repro_torch.kernels.fused_adamw import (fused_adamw_plain,
                                                 fused_adamw_update)
    shape = TRAIN_FLASH_SHAPE
    times = flash_timing(torch, *shape)
    others = {"pipeline": (PIPELINE_FLASH_SHAPE,
                           flash_timing(torch, *PIPELINE_FLASH_SHAPE)),
              "qwen": (QWEN_FLASH_SHAPE,
                       flash_timing(torch, *QWEN_FLASH_SHAPE))}
    libraries = {
        "flash_fwd": "F.scaled_dot_product_attention(is_causal=True) on "
                     "(B, H, S, D) copies",
        "flash_fwd_fp8": "null: no single PyTorch call attends with an fp8 "
                         "QK^T",
        "flash_bwd": "SDPA's backward through autograd "
                     "(torch.autograd.grad of F.scaled_dot_product_attention)"}
    for name, library in libraries.items():
        ms, plain_ms, lib_ms, nbytes, ops = times[name]
        at = {}
        for where, (oshape, t) in others.items():
            o_ms, o_plain, o_lib, o_bytes, o_ops = t[name]
            at[f"at_{where}_shape"] = dict(
                {"shape": list(oshape), "ms": o_ms, "plain_ms": o_plain,
                 "library_ms": o_lib}, **tc_bounds(name, o_bytes, o_ops))
        row(name, shape[:3] + shape[4:], ms, plain_ms, lib_ms, nbytes, ops,
            library=library, **at)
    bwd = {k: norm_bwd_times(torch, NORM_SHAPES[k], seed)
           for seed, k in enumerate(NORM_BWD_SHAPES)}
    t = bwd["training"]
    row("rmsnorm_bwd", NORM_SHAPES["training"], t["ms"], t["plain_ms"],
        t["library_ms"], t["nbytes"], t["ops"],
        library="F.rms_norm's backward through autograd (plain variant; "
                "null for the residual variant)",
        **{k: v for k, v in with_bound(t, "float32").items()
           if k.endswith("_residual")},
        at_pipeline_shape=with_bound(bwd["pipeline"], "float32"))
    g = torch.Generator().manual_seed(5)
    n = 65536 * 1280
    p, gr = (torch.randn(n, generator=g).cuda() for _ in range(2))
    m = (0.1 * torch.randn(n, generator=g)).cuda()
    v = torch.rand(n, generator=g).cuda()
    t = torch.tensor(3.0, device="cuda")
    scal = (torch.tensor(1e-3, device="cuda"), 1 - 0.9 ** t, 1 - 0.95 ** t)
    kw = dict(b1=0.9, b2=0.95, eps=1e-10, wd=0.0)
    p2, m2, v2 = p.clone(), m.clone(), v.clone()
    row("fused_adamw", (n,),
        time_ms(torch, lambda: fused_adamw_update(p, gr, m, v, *scal, **kw)),
        time_ms(torch, lambda: fused_adamw_plain(p, gr, m, v, *scal, **kw)),
        time_ms(torch, lambda: torch._fused_adamw_(
            [p2], [gr], [m2], [v2], [], [t], lr=1e-3, beta1=0.9,
            beta2=0.95, weight_decay=0.0, eps=1e-10, amsgrad=False,
            maximize=False)),
        28 * n, 14 * n,
        library="torch._fused_adamw_ on one flat leaf (updates p, m, v "
                "in place; the port's kernel returns u, m', v')")


def norm_bwd_times(torch, shape, seed):
    """The RMSNorm backward at ``shape`` (f32), plain and residual: the
    kernel's and the plain version's ms, ``F.rms_norm``'s backward
    through autograd for the plain variant, and each variant's bytes (x
    and dy read, dx written; the residual variant also reads the residual
    and dh; the scale read and dscale written once) and operations; the
    residual variant's under keys ending in ``_residual``."""
    import torch.nn.functional as F
    from repro_torch.kernels.rmsnorm import rmsnorm_bwd, rmsnorm_bwd_plain
    g = torch.Generator().manual_seed(50 + seed)
    x, r, dy, dh = (torch.randn(shape, generator=g).cuda() for _ in range(4))
    d = shape[-1]
    sc = (1 + 0.1 * torch.randn(d, generator=g)).cuda()
    n = x.numel()
    xl, wl = x.clone().requires_grad_(), sc.clone().requires_grad_()
    y_lib = F.rms_norm(xl, (d,), wl, 1e-5)
    bound_res = bound(5 * n * 4 + 2 * d * 4, 11 * n, "float32")
    return {
        "shape": list(shape),
        "ms": time_ms(torch, lambda: rmsnorm_bwd(dy, x, sc)),
        "plain_ms": time_ms(torch, lambda: rmsnorm_bwd_plain(dy, x, sc)),
        "library_ms": time_ms(torch, lambda: torch.autograd.grad(
            y_lib, (xl, wl), dy, retain_graph=True)),
        "nbytes": 3 * n * 4 + 2 * d * 4, "ops": 10 * n,
        "ms_residual": time_ms(torch, lambda: rmsnorm_bwd(
            dy, x, sc, residual=r, dh=dh)),
        "plain_ms_residual": time_ms(torch, lambda: rmsnorm_bwd_plain(
            dy, x, sc, 1e-5, r, dh)),
        "library_ms_residual": None, "bound_ms_residual": bound_res[0],
        "bound_by_residual": bound_res[1]}


def wire_rows(torch, row):
    """Timing rows of the outer-sync wire kernels at the main path's
    largest leaf: layers/mlp/w_up of two workers, (2, 131,072,000) f32
    with a residual; the int8 times in the row, the fp8 targets beside.
    Bounds: quantize_ef must read x and r and write q (1 byte) and r' once
    (13 bytes per element); dequantize reads 1 byte and writes 4."""
    from repro_torch.kernels.quantize import (dequantize, dequantize_plain,
                                              quantize_ef, quantize_ef_plain)
    g = torch.Generator().manual_seed(6)
    shape = (2, W_UP)
    n = shape[0] * shape[1]
    x = (torch.randn(shape, generator=g) * 1e-2).cuda()
    r = (torch.randn(shape, generator=g) * 1e-5).cuda()
    ms, plain_ms, dq_ms, dq_plain_ms = {}, {}, {}, {}
    dq_lib_ms = {t: None for t in WIRE_TARGETS}
    for target in WIRE_TARGETS:
        ms[target] = time_ms(torch, lambda: quantize_ef(x, r, dtype=target),
                             reps=10)
        plain_ms[target] = time_ms(
            torch, lambda: quantize_ef_plain(x, r, dtype=target), reps=5)
        q, _, sc = quantize_ef(x, r, dtype=target)
        dq_ms[target] = time_ms(torch, lambda: dequantize(q, sc), reps=10)
        dq_plain_ms[target] = time_ms(torch, lambda: dequantize_plain(q, sc),
                                      reps=5)
        if target == "int8":
            # one PyTorch call: int8 * f32 promotes inside one elementwise
            # kernel and gives the same function bit for bit
            check(torch.equal(torch.mul(q, sc), dequantize(q, sc)),
                  "torch.mul(int8 payload, scale) differs from dequantize")
            dq_lib_ms[target] = time_ms(torch, lambda: torch.mul(q, sc),
                                        reps=10)
        del q, sc
    none = ("null: no single PyTorch call computes the per-row amax scale, "
            "the clipped narrow payload and the error-feedback residual")
    row("quantize_ef", shape, ms["int8"], plain_ms["int8"], None, 13 * n,
        10 * n, target="int8", ms_by_target=ms,
        plain_ms_by_target=plain_ms, library=none)
    row("dequantize", shape, dq_ms["int8"], dq_plain_ms["int8"],
        dq_lib_ms["int8"], 5 * n, n, target="int8", ms_by_target=dq_ms,
        plain_ms_by_target=dq_plain_ms, library_ms_by_target=dq_lib_ms,
        library="torch.mul(q, scale) for int8 (one call, promotes to f32); "
                "null for fp8_e4m3 and fp8_e5m2: PyTorch does not promote "
                "float8 types, so their q.float() * scale is two kernels")
    del x, r
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------

def norm_timing(torch):
    """The norms' phase-7 timings alone, for this checkout's kernels:
    ``floor_ms``, then per shape of ``NORM_SHAPES`` the forward kernels'
    ms and bounds and, at ``NORM_BWD_SHAPES``, the backward's (plain and
    residual)."""
    from repro_torch.kernels import _build
    _build.build(["rmsnorm"])
    out = {"source": str(ROOT), "floor_ms": time_ms(
        torch, lambda: torch.cuda._sleep(0))}
    for seed, (k, shape) in enumerate(NORM_SHAPES.items()):
        out[k] = {n: with_bound(v, "float32") for n, v in
                  norm_fwd_times(torch, shape, seed).items()}
    for seed, k in enumerate(NORM_BWD_SHAPES):
        out[k]["rmsnorm_bwd"] = with_bound(
            norm_bwd_times(torch, NORM_SHAPES[k], seed), "float32")
    return out


def ssd_timing(torch):
    """The SSD's phase-7 timings alone, for this checkout's kernel:
    ``floor_ms``, then at each shape of ``SSD_TIMING_SHAPES`` the kernel's
    and the plain version's ms with the bound and roofs."""
    from repro_torch.kernels import _build
    _build.build(["ssd"])
    out = {"source": str(ROOT), "floor_ms": time_ms(
        torch, lambda: torch.cuda._sleep(0))}
    for k, shape in SSD_TIMING_SHAPES.items():
        out[k] = with_tc_bound(ssd_times(torch, shape), "ssd")
    return out


def gpu_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", type=str, default=None,
                    help="also write the full report as JSON to this file")
    ap.add_argument("--norm-timing", action="store_true",
                    help="only build the RMSNorm kernels of this checkout "
                         "and time them at NORM_SHAPES beside the floor "
                         "(one JSON line): to set two checkouts side by "
                         "side in one run on one card")
    ap.add_argument("--ssd-timing", action="store_true",
                    help="only build the SSD kernel of this checkout and "
                         "time it at SSD_TIMING_SHAPES beside the floor "
                         "(one JSON line), as --norm-timing")
    args = ap.parse_args(argv)
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found; run from a checkout "
              "of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.norm_timing or args.ssd_timing:
        print(json.dumps(norm_timing(torch) if args.norm_timing
                         else ssd_timing(torch)))
        print(gpu_line())
        return 0
    report = {"gpu": gpu_line(), "torch": torch.__version__,
              "cuda": torch.version.cuda}
    t_start = time.perf_counter()
    phase_s = report["phase_s"] = {}
    last = [t_start]

    def lap(name):
        now = time.perf_counter()
        phase_s[name] = now - last[0]
        last[0] = now
        log(f"  phase {name}: {phase_s[name]:.1f} s")

    try:
        sdpa = report["sdpa_kernels"] = sdpa_kernels(torch,
                                                     *TRAIN_FLASH_SHAPE)
        for part, kernels in sdpa.items():
            log(f"SDPA f32 causal {part} at (B, S, H, KV, D) "
                f"{TRAIN_FLASH_SHAPE} launches " + ("; ".join(
                    f"{n} ({us:.1f} us)" for n, us in kernels.items())
                    or "not measured (no device time recorded)"))
        from repro_torch.kernels import _build
        log("[1/7] build kernels")
        t0 = time.perf_counter()
        text = _build.build(verbose=True)
        report["build_s"] = time.perf_counter() - t0
        for line in text.splitlines():
            if "Used" in line or "spill" in line or "error" in line.lower():
                log("  " + line.strip())
        log(f"  built in {report['build_s']:.1f} s")
        lap("1 build")

        log("[2/7] kernels vs plain versions")
        checks = []
        phase_kernels(torch, checks)
        phase_split_invariants(torch, checks)
        phase_quant_kernels(torch, checks)
        phase_train_kernels(torch, checks)
        phase_wire_kernels(torch, checks)
        phase_static_kernels(torch, checks)
        phase_fp8_flash_kernels(torch, checks)
        phase_flash_determinism(torch, checks)
        phase_norm_kernels(torch, checks)
        report_checks(checks)
        report["checks"] = [list(c) for c in checks]
        lap("2 kernels")

        log("[3/7] full width, depth 2: card vs CPU")
        report["step_vs_cpu"] = phase_step_vs_cpu(torch)
        report["quant_step_vs_cpu"] = phase_quant_step_vs_cpu(torch)
        report["train_step_vs_cpu"] = phase_train_step_vs_cpu(torch)
        report["wire_round_vs_cpu"] = phase_wire_round_vs_cpu(torch)
        report["static_step_vs_cpu"] = phase_static_step_vs_cpu(torch)
        lap("3 depth-2 vs CPU")

        log("[4/7] Engine, nanochat-d20: f32, int8, fp8 and fp8_e5m2 "
            "pools, fp8 QK^T; spec_k=0 and 4; capacity")
        runs, report["profile"] = phase_engine(torch)
        capacity = runs.pop("capacity")
        report["engine"] = runs
        report["capacity"] = capacity
        log("[4/7 cont.] static-bucket path and scoring: mamba2-1.3b (full "
            "width and depth) generate and score; nanochat-d20 over "
            "capacity")
        static = phase_static_serving(torch)
        report["static"] = static
        lap("4 serving")

        log("[4b/7] the dense configs at full width: qwen1.5-0.5b (24 "
            "layers), command-r-plus-104b (2), mistral-large-123b (4), "
            "nemotron-4-15b (8): serving spec_k 0 / 4 and static; qwen's "
            "DiLoCo round")
        archs = report["archs"] = phase_archs(torch, checks)
        report["checks"] = [list(c) for c in checks]
        lap("4b archs")

        log("[5/7] training, nanochat-d20: DiLoCo and DDP on the f32 wire; "
            "DiLoCo on int8, fp8 and fp8_e5m2 wires, compressed DDP, "
            "streaming, overlapped and pipelined on the lossy wire")
        train, report["train_profile"] = phase_train(torch)
        report["train"] = train
        lap("5 training")

        log("[6/7] pipeline, nanochat-d20 at full width: base -> mid -> "
            "SFT with evals after each stage, DiLoCo and hybrid")
        t0 = time.perf_counter()
        pipeline = phase_pipeline(torch)
        report["pipeline"] = pipeline
        report["pipeline_s"] = time.perf_counter() - t0
        lap("6 pipeline")

        log("[6b/7] remat at full depth (K 2 and 4), run checkpoints and "
            "resume (diloco and pipelined on the int8 wire), prefetch and "
            "the eval hook at depth 2, drift on a short DiLoCo run")
        state = report["state"] = phase_state(torch)
        lap("6b state")

        log("[6c/7] gossip, nanochat-d20 at full width, K 4, int8 wire: "
            "ring and random, async gossip (jitter 1, bound 1); jitter 0 "
            "== gossip and resume at depth 2; the comm report")
        gossip = report["gossip"] = phase_gossip(
            torch, pipeline["diloco"]["stages"]["base"]["step_seconds"])
        lap("6c gossip")

        log("[6d/7] the fault layer, nanochat-d20 at full width, K 4, int8 "
            "wire: DiLoCo and gossip through crash, rejoin, dropped "
            "payloads; bit-for-bit gates at depth 2; the comm report under "
            "faults")
        faults = report["faults"] = phase_faults(
            torch, pipeline["diloco"]["stages"]["base"]["step_seconds"],
            min(gossip["runs"][p]["step_seconds"]
                for p in ("gossip", "gossip_random")))
        lap("6d faults")

        log("[6e/7] GRPO, nanochat-d20 at full width: 16 prompts x G 8, "
            "4 iterations and the first again; the depth-2 update against "
            "the CPU")
        grpo = report["grpo"] = phase_grpo(torch)
        lap("6e grpo")

        log("[7/7] kernel timing")
        paths = {name: run["launches"] for name, run in runs.items()}
        paths.update({m: run["launches"] for m, run in train.items()})
        paths.update({f"pipeline_{m}": run["launches"]
                      for m, run in pipeline.items()})
        paths.update({m: run["launches"] for m, run in static.items()
                      if "launches" in run})
        paths.update({f"state_{n}": c
                      for n, c in state["launches"].items()})
        paths.update(gossip["launches"])
        paths.update(faults["launches"])
        for arch, run in archs.items():
            paths.update({f"{arch}_{part}": run[part]["launches"]
                          for part in ("spec_k0", "spec_k4", "static")})
            if "train" in run:
                paths[f"{arch}_train"] = run["train"]["launches"]
        paths.update(grpo["launches"])
        floor = report["floor_ms"] = time_ms(
            torch, lambda: torch.cuda._sleep(0))
        kernels = phase_timing(torch, paths, checks)
        report["kernels"] = kernels
        for k in kernels:
            log(f"  {k['name']:17s} ms={k['ms']:.4f} plain_ms="
                f"{k['plain_ms']:.4f} library_ms={k['library_ms']} "
                f"bound_ms={k['bound_ms']:.5f} ({k['bound_by']}) "
                f"launches={k['launches_by_path']}")
            for key, v in k.items():
                if key.startswith("at_") and key.endswith("_shape"):
                    log(f"  {'':17s} {key} {v['shape']}: " + " ".join(
                        f"{n}={v[n]}" for n in v if n != "shape"))
            if k["name"] == "rmsnorm_residual":
                log(f"  {'floor':17s} ms={floor:.4f} (the same timing of "
                    f"an empty kernel, torch.cuda._sleep(0): not a kernel "
                    f"row)")
            if "ms_residual" in k:
                log(f"  {'':17s} residual variant: " + " ".join(
                    f"{n}={v}" for n, v in k.items()
                    if n.endswith("_residual")))
        split = report["split_timing"] = phase_split_timing(torch)
        for name in ("paged_verify_full", "paged_verify_phase7",
                     "ring_decode_full", "ring_decode_phase7"):
            log(f"  {name:19s} ms by CHUNK_KEYS " + " ".join(
                f"{ck}:{ms:.4f}" for ck, ms in split[name].items()))
        for name, us in split["device_us"].items():
            log(f"  {name:27s} device us per launch: " + ", ".join(
                f"{part} {'not measured' if t is None else f'{t:.2f}'}"
                for part, t in us.items()))
        lap("7 timing")
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    report["total_s"] = time.perf_counter() - t_start
    log(f"all phases passed in {report['total_s']:.1f} s")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1, default=str))
    summary = {k: {"tokens_per_s": v["tokens_per_s"], "wall_s": v["wall_s"],
                   "agreement_with_f32": v["agreement_with_f32"]}
               for k, v in runs.items()}
    train_summary = {k: {key: v.get(key) for key in (
        "tokens_per_s", "step_seconds", "peak_memory_gb", "loss",
        "wire_bytes_per_worker_per_sync", "outer_sync_ms")}
        for k, v in train.items()}
    static_summary = {k: {key: v.get(key) for key in (
        "tokens_per_s", "wall_s", "ms_per_step",
        "static_vs_scheduler_agreement", "busy_share")}
        for k, v in static.items()}
    pipeline_summary = {m: {stage: {
        "method": e["method"], "loss": [e["loss_first"], e["loss_last"]],
        "step_seconds": e["step_seconds"],
        "tokens_per_s": e["port"]["tokens_per_s"],
        "heldout_ce": e["core"]["heldout_ce"], "tasks": e["tasks"],
        "eval_seconds": e["port"]["eval_seconds"]}
        for stage, e in run["stages"].items()} for m, run in pipeline.items()}
    state_summary = {
        "remat_rounds": state["remat"]["rounds"],
        "remat_step_s": state["remat"]["step_s"],
        "remat_step_peak_gb": state["remat"]["step_peak_gb"],
        "resume": {p: {k: v[k] for k in ("checkpoints", "resumed_from",
                                          "bits_equal", "checkpoint_bytes")}
                   for p, v in state["resume"].items()},
        "prefetch_bits_equal":
            state["resume"]["diloco_int8"]["prefetch_bits_equal"],
        "drift": {k: v for k, v in state["drift"].items()
                  if k != "worker_cka"},
        "pipeline_k4_fits": state["pipeline_k4_fits"]}
    gossip_summary = {
        "runs": {p: {key: v[key] for key in (
            "layers", "step_seconds", "tokens_per_s", "peak_memory_gb",
            "loss", "wire_bytes_per_worker_per_round",
            "schedule_bytes_per_worker")}
            for p, v in gossip["runs"].items()},
        "async_depth": gossip["async_depth"], "state": gossip["state"],
        "comm_report": {m: {"homogeneous_s":
                                r["homogeneous"]["wall_clock_s"],
                            "heterogeneous_s":
                                r["heterogeneous"]["wall_clock_s"],
                            "pair_barrier_s": r.get("gossip", {}).get(
                                "wall_clock_s"),
                            "bytes_per_worker":
                                r["homogeneous"]["total_bytes"],
                            "step_time_s": r["step_time_s"],
                            "link_bytes_per_s": r["link_bytes_per_s"]}
                        for m, r in gossip["comm_report"].items()}}
    faults_summary = {
        "runs": {p: {key: v[key] for key in (
            "schedule", "loss", "quorum", "rejoin_drift",
            "rejoin_drift_rel_err", "layers", "inner_step_s", "step_seconds",
            "peak_memory_gb", "seconds",
            "inner_step_launches_all_live",
            "inner_step_launches_worker_down")}
            for p, v in faults["runs"].items()},
        "state": faults["state"], "state_seconds": faults["state_seconds"],
        "comm_report": {m: {f"{kind}_{key}": r[kind]["heterogeneous"][key]
                            for kind in ("fault_free", "faulted")
                            for key in ("wall_clock_s", "total_bytes",
                                        "retry_bytes")}
                        for m, r in faults["comm_report"].items()}}
    archs_summary = {a: dict(
        {part: {k: v for k, v in r[part].items() if k in (
            "tokens_per_s", "wall_s", "ms_per_step_call",
            "ms_per_decode_step")}
         for part in ("spec_k0", "spec_k4", "static")},
        layers=r["layers"], peak_memory_gb=r["peak_memory_gb"])
        for a, r in archs.items()}
    archs_summary[QWEN]["train"] = {k: archs[QWEN]["train"][k] for k in (
        "loss", "step_seconds", "tokens_per_s", "peak_memory_gb", "vs_cpu")}
    grpo_summary = {"p_reward_set": grpo["p_reward_set"],
                    "vs_cpu": grpo["vs_cpu"], "profiled": [{
                        k: r[k] for k in ("rollout_s", "update_s",
                                          "busy_share")}
                        for r in grpo["profiled"]],
                    "iterations": [{k: r[k] for k in (
                        "loss", "mean_reward", "rollout_s", "update_s",
                        "sampled_tokens_per_s", "peak_memory_gb")}
                        for r in grpo["iterations"]]}
    print(json.dumps({"engine": summary, "capacity": capacity,
                      "train": train_summary, "static": static_summary,
                      "archs": archs_summary, "pipeline": pipeline_summary,
                      "state": state_summary, "gossip": gossip_summary,
                      "faults": faults_summary, "grpo": grpo_summary,
                      "phase_s": phase_s, "floor_ms": floor}))
    print(json.dumps({"split_timing": report["split_timing"]}))
    print(report["gpu"])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
