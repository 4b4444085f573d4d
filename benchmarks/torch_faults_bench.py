"""Elastic-training degradation benchmark in the PyTorch port (the torch
counterpart of ``benchmarks/faults_bench.py``, with the same scenario and
output lines): K 8 DiLoCo through a scripted crash/rejoin schedule
against the same run fault-free, on identical data.

Losing 2 of 8 workers mid-run (one of them rejoining later at the
current anchor) must cost almost nothing: the bar is a final loss within
2% of the fault-free run, and the script exits 1 when it is missed.  It
also prints the per-round quorum sizes (8 -> 7 -> 6 -> 7 across the
events), every fault record the tracker emitted, and the rejoin drift
(the rejoiner's delta norm and its cosine to the live mean, taken before
it adopts the anchor; ``core/drift.py rejoin_drift``).

The model is the reference's: nanochat-d20's reduced config cut to one
layer, d 16, one head, d_ff 64, vocab 512; K 8, H 8, 48 steps, batches of
4 x 16 random tokens per worker, made with numpy from a seed.  Runs on
the card by default (``--device cpu`` runs the kernels' plain versions).

  PYTHONPATH=src python benchmarks/torch_faults_bench.py \\
      [--steps 48] [--h 8] [--device cuda|cpu] [--fused-adamw] \\
      [--out faults.json]
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict

import numpy as np
import torch

from repro_torch.configs import get_reduced
from repro_torch.configs.base import DiLoCoConfig, OptimizerConfig
from repro_torch.core import DistTrainer, FaultSchedule, make_strategy
from repro_torch.models import init_params, lm_loss
from repro_torch.serving import resolve_device


def degradation_rows(steps: int = 48, k: int = 8, h: int = 8,
                     device="cuda", fused_adamw: bool = False) -> Dict:
    """The faulted and the fault-free run, on the same data from the same
    parameters; returns the reference's section keys plus ``device`` and
    the seconds a step of each run took."""
    device = resolve_device(device)
    cfg = get_reduced("nanochat-d20").with_(
        name="nanochat-d20-tiny", num_layers=1, d_model=16, num_heads=1,
        num_kv_heads=1, head_dim=16, d_ff=64, vocab_size=512)
    params = init_params(cfg, seed=0, device=device)
    opt = OptimizerConfig(total_steps=steps, warmup_steps=0,
                          schedule="constant", learning_rate=0.02,
                          adam_lr=1e-3, muon_ns_steps=2, grad_clip=0.0,
                          fused_adamw=fused_adamw)
    dcfg = DiLoCoConfig(num_workers=k, h_inner_steps=h, strategy="diloco")

    def data(step):
        toks = np.random.default_rng(1000 + step).integers(
            0, cfg.vocab_size, (k, 4, 16)).astype(np.int32)
        return {"tokens": toks, "labels": (toks + 1) % cfg.vocab_size}

    # 2 crashes + 1 rejoin, spread over the middle of the run: worker 2
    # dies in round 2, worker 5 in round 3, worker 2 returns for the
    # second-to-last round and adopts the current anchor
    c1, c2, rj = h + h // 2, 2 * h + h // 2, steps - 2 * h - 1
    spec = f"crash:2@{c1},crash:5@{c2},rejoin:2@{rj}"

    losses, step_s, faulted = {}, {}, None
    for name, faults in (("no_fault", None),
                         ("faulted", FaultSchedule.from_spec(spec))):
        dt = DistTrainer(lambda p, b: lm_loss(p, b, cfg), opt, dcfg,
                         make_strategy(dcfg))
        t0 = time.perf_counter()
        _, hist = dt.run(dt.init(params), data, steps, faults=faults)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        step_s[name] = (time.perf_counter() - t0) / steps
        losses[name] = float(hist["loss"][-1])
        if faults is not None:
            faulted = hist
    frac = ((losses["faulted"] - losses["no_fault"])
            / abs(losses["no_fault"]))
    return {
        "arch": cfg.name, "steps": steps, "k": k, "h": h,
        "schedule": spec, "device": device.type,
        "no_fault_loss": losses["no_fault"],
        "faulted_loss": losses["faulted"],
        "loss_vs_no_fault_frac": frac,
        "within_2pct": abs(frac) <= 0.02,
        "quorum_per_round": [list(q) for q in faulted["quorum"]],
        "events": [list(e) for e in faulted.get("fault", [])],
        "rejoin_drift": [list(r) for r in faulted.get("rejoin_drift", [])],
        "seconds_per_step": step_s,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=48)
    ap.add_argument("--h", type=int, default=8)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--fused-adamw", action="store_true",
                    help="AdamW through the fused kernel")
    ap.add_argument("--out", default=None, help="also write the section "
                    "as JSON to this file")
    args = ap.parse_args(argv)
    sec = degradation_rows(steps=args.steps, h=args.h, device=args.device,
                           fused_adamw=args.fused_adamw)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(sec, f, indent=1)
    print("name,us_per_call,derived")
    print(f"faults/{sec['arch']}/degradation,0.0,"
          f"no_fault={sec['no_fault_loss']:.4f} "
          f"faulted={sec['faulted_loss']:.4f} "
          f"delta={100 * sec['loss_vs_no_fault_frac']:+.2f}% "
          f"within_2pct={sec['within_2pct']}")
    print(f"faults/{sec['arch']}/quorum,0.0,"
          f"sizes={[n for _, n in sec['quorum_per_round']]}")
    print(f"faults/{sec['arch']}/events,0.0,{sec['events']}")
    for step, worker, norm, cos in sec["rejoin_drift"]:
        print(f"faults/{sec['arch']}/rejoin_drift,0.0,"
              f"step={step} worker={worker} norm={norm:.4f} cos={cos:.4f}")
    print(f"faults/{sec['arch']}/seconds_per_step,0.0,"
          f"{sec['seconds_per_step']} device={sec['device']}")
    return 0 if sec["within_2pct"] else 1


if __name__ == "__main__":
    sys.exit(main())
