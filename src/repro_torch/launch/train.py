"""Training launcher — the base stage of the paper's pipeline as a CLI
(the JAX package's ``launch/train.py``, base stage only):

  --method ddp         fully synchronous baseline (K = 1 on the global
                       batch); with --grad-compress int8|fp8|fp8_e5m2, K
                       workers averaging their per-step updates through
                       that codec (ddp_compressed)
  --method diloco      DiLoCo: K workers, H inner steps of Muon + AdamW,
                       then the outer Nesterov step
  --method streaming   one of --fragments F fragments every H/F steps
  --method overlapped  the outer update lands --sync-delay steps after the
                       capture; --h-jitter straggler jitter on the capture
  --method pipelined   one fragment per round, applied --sync-delay later

    PYTHONPATH=src python -m repro_torch.launch.train --method diloco \\
        --steps 30 --workers 2 [--delta-dtype int8|fp8|fp8_e5m2|bfloat16] \\
        [--no-error-feedback] [--drift-aware] [--fused-adamw] \\
        [--device cuda|cpu]

``--delta-dtype`` picks the outer-sync wire codec (int8 and fp8 carry
per-tensor scales and an error-feedback residual and run the quantize
kernels on the card; see ``repro_torch.core.transport``).  Runs on the
card by default and raises without one; ``--device cpu`` runs the
kernels' plain PyTorch versions.  The corpus is the synthetic world of
``repro_torch.data.synthetic`` (the same texts and tokenizer as the JAX
pipeline's base stage); H is steps // 3 as in the JAX pipeline's base
stage, and the optimizer schedule spans the JAX pipeline's three stages
(steps + 2 * (steps // 2)), so the base stage here follows the JAX
pipeline's base stage step for step.

Not ported yet, and raising ``NotImplementedError``: the mid and SFT
stages with ``run_pipeline`` and the evals, ``--method hybrid``, the
gossip strategies, run checkpoints and faults.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

from repro_torch.configs import NANOCHAT_D20
from repro_torch.configs.base import (DiLoCoConfig, ModelConfig,
                                      OptimizerConfig)


def build_pipeline(vocab_budget: int = 512, seq_len: int = 128,
                   n_pretrain: int = 6000, seed: int = 0):
    """Tokenizer and the base-stage dataset of the synthetic world.
    Returns (world, tokenizer, {"base": PackedDataset}); the mid and SFT
    stages of the JAX pipeline are not built."""
    from repro_torch.data import PackedDataset, synthetic, train_tokenizer
    world = synthetic.World.make(40, seed=1234 + seed)
    pre_texts = synthetic.gen_pretrain_texts(world, n_pretrain, seed=seed)
    tok = train_tokenizer(pre_texts[:2000], vocab_budget)
    return world, tok, {"base": PackedDataset.from_texts(pre_texts, tok,
                                                         seq_len)}


def make_model(arch: str, vocab_size: int) -> ModelConfig:
    """``tiny`` (the JAX launcher's tiny nanochat, vocab = the
    tokenizer's) or ``nanochat-d20`` at its published widths — its 65536
    vocab is kept, so the card runs the full-width unembedding (the
    tokenizer's ids are a subset)."""
    if arch == "tiny":
        return ModelConfig(name="tiny-nanochat", num_layers=4, d_model=128,
                           num_heads=4, num_kv_heads=4, d_ff=512,
                           vocab_size=vocab_size, tie_embeddings=True)
    if arch == "nanochat-d20":
        return NANOCHAT_D20
    raise NotImplementedError(f"arch {arch!r}: the port has tiny and "
                              f"nanochat-d20")


def run_stage(method: str, cfg: ModelConfig, params, stage_ds, *,
              steps: int, workers: int, per_worker_batch: int, h: int,
              opt_cfg: OptimizerConfig, diloco_cfg: DiLoCoConfig,
              seed: int = 0, h_schedule=None, prefetch: int = 0,
              faults=None, checkpoint_dir: Optional[str] = None,
              checkpoint_every: int = 0, resume: bool = False):
    """Run one pipeline stage of ``cfg`` from ``params`` (a parameter tree
    on the device to train on) under ``method``; returns (final global
    parameter tree, history).  Every method goes through ``DistTrainer``;
    ``method`` picks the sync strategy."""
    from repro_torch.core import (DistTrainer, compressed_ddp_config,
                                  make_strategy)
    from repro_torch.models import lm_loss
    from repro_torch.models.transformer import unflatten

    if h_schedule is not None:
        raise NotImplementedError("H schedules other than a fixed H "
                                  "(adaptive H) are not ported")

    def worker_data(step):
        return stage_ds.worker_batches(step, workers, per_worker_batch,
                                       seed=seed)

    if method == "ddp" and diloco_cfg.grad_compress not in ("", "none"):
        # DDP-side gradient compression: K real workers exchanging their
        # per-step updates through the codec (core.sync.CompressedDDPSync)
        dcfg = compressed_ddp_config(
            dataclasses.replace(diloco_cfg, num_workers=workers))
        data = worker_data
    elif method == "ddp":
        dcfg = dataclasses.replace(diloco_cfg, num_workers=1,
                                   h_inner_steps=1, outer_lr=1.0,
                                   outer_momentum=0.0, nesterov=False,
                                   strategy="ddp")

        def data(step):
            b = stage_ds.batch(step, workers * per_worker_batch, seed=seed)
            return {k: v[None] for k, v in b.items()}
    else:
        # clamp the overlap knobs to the stage's H (a stage's budget can
        # shrink H below a globally configured delay / jitter)
        delay = min(diloco_cfg.sync_delay, h - 1)
        jitter = min(diloco_cfg.h_jitter, h - 1 - delay)
        dcfg = dataclasses.replace(diloco_cfg, num_workers=workers,
                                   h_inner_steps=h, strategy=method,
                                   sync_delay=delay, h_jitter=jitter)
        data = worker_data

    trainer = DistTrainer(lambda p, b: lm_loss(p, b, cfg), opt_cfg, dcfg,
                          make_strategy(dcfg))
    state = trainer.init(params)
    state, hist = trainer.run(state, data, steps, prefetch=prefetch,
                              faults=faults, checkpoint_dir=checkpoint_dir,
                              checkpoint_every=checkpoint_every,
                              resume=resume)
    return unflatten(state.global_params), hist


def run_pipeline(*args, **kwargs):
    raise NotImplementedError("the three-stage pipeline (mid-training, SFT, "
                              "evals) is not ported; run_stage runs the "
                              "base stage")


def main(argv=None) -> dict:
    from repro_torch.core.transport import reset_shipped, shipped
    from repro_torch.models import init_params
    from repro_torch.serving import resolve_device
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--method", default="diloco",
                    help="ddp | diloco | streaming | overlapped | pipelined "
                         "(gossip, async_gossip and hybrid are not ported)")
    ap.add_argument("--arch", default="tiny",
                    choices=["tiny", "nanochat-d20"])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--fused-adamw", action="store_true",
                    help="AdamW through the fused kernel")
    ap.add_argument("--delta-dtype", default="float32",
                    choices=["float32", "f32", "bfloat16", "bf16", "int8",
                             "fp8", "e5m2", "fp8_e5m2"],
                    help="the outer-sync wire codec")
    ap.add_argument("--no-error-feedback", action="store_true",
                    help="disable the lossy codecs' error-feedback residual")
    ap.add_argument("--grad-compress", default="none",
                    choices=["none", "int8", "fp8", "fp8_e5m2"],
                    help="--method ddp only: K workers exchange their "
                         "per-step updates through this codec")
    ap.add_argument("--drift-aware", action="store_true",
                    help="weigh each worker's delta by its cosine to the "
                         "mean")
    ap.add_argument("--sync-delay", type=int, default=0,
                    help="overlapped/pipelined: steps between delta capture "
                         "and apply")
    ap.add_argument("--h-jitter", type=int, default=0,
                    help="overlapped: max per-worker straggler jitter on "
                         "the capture")
    ap.add_argument("--fragments", type=int, default=4,
                    help="streaming/pipelined: number of fragments F")
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.method == "hybrid":
        raise NotImplementedError("--method hybrid needs the mid/SFT stages, "
                                  "which are not ported")
    device = resolve_device(args.device)
    per_worker_batch, seq_len = 8, 128       # the JAX pipeline's defaults
    _, tok, stages = build_pipeline(seq_len=seq_len, seed=args.seed)
    cfg = make_model(args.arch, tok.vocab_size)
    params = init_params(cfg, seed=args.seed, device=device)
    total = args.steps + 2 * (args.steps // 2)
    opt_cfg = OptimizerConfig(total_steps=total, warmup_steps=20,
                              schedule="wsd", learning_rate=0.02,
                              adam_lr=1e-3, fused_adamw=args.fused_adamw)
    dcfg = DiLoCoConfig(num_workers=args.workers, sync_seed=args.seed,
                        delta_dtype=args.delta_dtype,
                        error_feedback=not args.no_error_feedback,
                        grad_compress=args.grad_compress,
                        drift_aware=args.drift_aware,
                        sync_delay=args.sync_delay, h_jitter=args.h_jitter,
                        num_fragments=args.fragments)
    reset_shipped()
    t0 = time.perf_counter()
    _, hist = run_stage(args.method, cfg, params, stages["base"],
                        steps=args.steps, workers=args.workers,
                        per_worker_batch=per_worker_batch,
                        h=max(args.steps // 3, 1), opt_cfg=opt_cfg,
                        diloco_cfg=dcfg, seed=args.seed)
    wall = time.perf_counter() - t0
    tokens = args.steps * args.workers * per_worker_batch * seq_len
    kernels = "cuda" if device.type == "cuda" else "plain"
    syncs = len(hist["sync_steps"]) + len(hist["frag_syncs"])
    print(f"[{args.method}:base] {cfg.name} device={device.type} "
          f"kernels={kernels} loss {hist['loss'][0]:.3f} -> "
          f"{hist['loss'][-1]:.3f} syncs={syncs} "
          f"wire_bytes={dict(shipped)} "
          f"step_seconds={hist['step_seconds']:.4f} "
          f"tokens_per_s={tokens / wall:.1f}")
    return hist


if __name__ == "__main__":
    main()
