"""Drift analysis in the PyTorch port — quantifying the paper's §4.3
"representation drift" hypothesis (the torch counterpart of
``benchmarks/drift_analysis.py``, with the same output lines).

Trains the same model with DDP and with DiLoCo, then measures:
  * per-worker parameter-delta dispersion during DiLoCo training,
  * pairwise CKA between workers' hidden representations just before a sync,
  * CKA between the final DiLoCo model and the final DDP model on a probe
    batch (low = drifted representation geometry, the paper's explanation
    for the Hybrid configuration's failure).

The probe is the port's ``forward_hidden`` (the final-normed hidden
states).  Defaults are the reference's: a 4-layer, d 128 model, 120
steps, K 4, H 20; ``--arch nanochat-d20`` runs nanochat-d20 at full width
and depth with the tokenizer's 512-token vocab.  Runs on the card by
default (``--device cpu`` runs the kernels' plain versions).

  PYTHONPATH=src python benchmarks/torch_drift_analysis.py \\
      [--arch tiny|nanochat-d20] [--steps 120] [--device cuda|cpu] \\
      [--fused-adamw]
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs.base import (DiLoCoConfig, ModelConfig,
                                      OptimizerConfig)
from repro_torch.core import DDPTrainer, DiLoCoTrainer, drift
from repro_torch.data import PackedDataset, synthetic, train_tokenizer
from repro_torch.launch.train import make_model
from repro_torch.models import init_params, lm_loss
from repro_torch.models.transformer import forward_hidden, unflatten
from repro_torch.serving import resolve_device

WORKERS, H = 4, 20


def hidden_states(params, batch, cfg):
    """Final-normed hidden states (B*S, d) as the representation probe;
    ``params`` is a flat dict."""
    with torch.no_grad():
        h, _ = forward_hidden(unflatten(params), batch, cfg)
    return h.reshape(-1, h.shape[-1])


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="tiny", choices=["tiny", "nanochat-d20"])
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--fused-adamw", action="store_true",
                    help="AdamW through the fused kernel")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    steps = args.steps

    world = synthetic.World.make(40)
    texts = synthetic.gen_pretrain_texts(world, 3000)
    tok = train_tokenizer(texts[:1200], 512)
    ds = PackedDataset.from_texts(texts, tok, seq_len=128)
    if args.arch == "tiny":
        cfg = ModelConfig(num_layers=4, d_model=128, num_heads=4,
                          num_kv_heads=4, d_ff=512, vocab_size=tok.vocab_size)
    else:
        cfg = make_model(args.arch, False, tok.vocab_size)
    params = init_params(cfg, seed=0, device=device)
    opt = OptimizerConfig(total_steps=steps, warmup_steps=10,
                          learning_rate=0.02, adam_lr=1e-3,
                          fused_adamw=args.fused_adamw)
    loss_fn = lambda p, b: lm_loss(p, b, cfg)

    def put(batch):
        return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}

    probe = put(ds.batch(999999, 8))
    probe_fn = lambda p, b: hidden_states(p, b, cfg)

    print("name,us_per_call,derived")

    # --- DiLoCo with drift measured at each sync ----------------------------
    tr = DiLoCoTrainer(loss_fn, opt, DiLoCoConfig(num_workers=WORKERS,
                                                  h_inner_steps=H))
    state = tr.init(params)
    for step in range(steps):
        state, _ = tr.inner_step(state, put(ds.worker_batches(step, WORKERS,
                                                              8)))
        if (step + 1) % H == 0:
            d = drift.param_drift(state.worker_params, state.global_params)
            cka = drift.worker_cka_matrix(state.worker_params, probe_fn,
                                          probe)
            k = cka.shape[0]
            off = (float(cka.sum()) - k) / (k * (k - 1))
            print(f"drift/step{step+1},0.0,"
                  f"delta_norm={float(d['delta_norm_mean']):.4f} "
                  f"pairwise_param_cos={float(d['pairwise_cos']):.4f} "
                  f"worker_cka={off:.4f}", flush=True)
            state = tr.outer_step(state)
    diloco_params = state.global_params
    del state

    # --- DDP reference -------------------------------------------------------
    ddp = DDPTrainer(loss_fn, opt)
    dstate = ddp.init(params)
    for step in range(steps):
        dstate, _ = ddp.train_step(dstate, put(ds.batch(step, 32)))

    a = probe_fn(diloco_params, probe)
    b = probe_fn(dstate.params, probe)
    cka = float(drift.linear_cka(a, b))
    sub = float(drift.subspace_overlap(a, b, r=8))
    print(f"drift/final_diloco_vs_ddp,0.0,cka={cka:.4f} "
          f"subspace_overlap_r8={sub:.4f}")


if __name__ == "__main__":
    main()
