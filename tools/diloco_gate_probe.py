#!/usr/bin/env python3
"""Why independent DiLoCo rounds on the card and on the CPU part by up
to ~2e-3 of a leaf's largest magnitude under some weight draws.
(``chip_smoke.py`` phase 3 gates the round from one shared
post-inner-step state instead, which holds bit for bit at any draw; this
probe measures the spread of independent rounds, which that phase
prints without gating.)

    python3 tools/diloco_gate_probe.py [--seeds 0,1,2,3] [--out FILE]
    python3 tools/diloco_gate_probe.py --shared-state [--seeds 0,1,2,3]

Run from the root of a checkout on a machine with an NVIDIA GPU and nvcc.
For each weight seed: nanochat-d20 at full width and depth 2 (phase 3's
``train_step_vs_cpu`` config and tokens), one DiLoCo round (K 2, H 1,
fused AdamW, the phase's optimizer config) on the card and on the CPU
from the same parameters, and the elements of each leaf whose global
parameters part by more than 1e-4 of the leaf's largest magnitude.  At
those elements, each worker's first inner-step gradient on the card, on
the CPU in float32 and on the CPU in float64 (the port's plain
path with ``Tensor.float`` left as float64 for float64 tensors, and a
float64 compute dtype).  AdamW's first step is ``lr g / (|g| + eps)`` at
eps 1e-10: ± lr for any |g| far above 1e-10, so an element whose
gradient is zero up to float32 rounding takes either sign.  Prints one
line per seed (the largest such part, the elements past 1e-4, how many
have the two devices' gradient signs apart, and where float64 sides; per
worker ``grad_rel``, the worst leaf's max |card - CPU| gradient over its
max |g|), then the card's name and power limit; ``--out`` writes
everything as JSON.  ``--shared-state`` runs phase 3's training step and
DiLoCo round itself (``chip_smoke.phase_train_step_vs_cpu``, its gates
included) at each seed instead, and prints its readings: the round from
one shared state, and the independent one beside it.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def float64_grads(torch, params, batch, cfg):
    """The inner step's gradients on the CPU in float64."""
    from repro_torch.models import layers, lm_loss
    from repro_torch.models.transformer import unflatten
    orig = torch.Tensor.float
    torch.Tensor.float = (lambda self, *a, **k: self if self.dtype ==
                          torch.float64 else orig(self, *a, **k))
    layers._DTYPES["float64"] = torch.float64
    try:
        leaves = {k: v.double().requires_grad_() for k, v in params.items()}
        loss, _ = lm_loss(unflatten(leaves), batch,
                          cfg.with_(compute_dtype="float64",
                                    param_dtype="float64"))
        return dict(zip(leaves, torch.autograd.grad(loss,
                                                    list(leaves.values()))))
    finally:
        torch.Tensor.float = orig
        del layers._DTYPES["float64"]


def grads(torch, params, batch, cfg, dev):
    from repro_torch.models import lm_loss
    from repro_torch.models.transformer import unflatten
    leaves = {k: v.to(dev).clone().requires_grad_() for k, v in params.items()}
    loss, _ = lm_loss(unflatten(leaves), {k: v.to(dev) for k, v in
                                          batch.items()}, cfg)
    return {k: g.cpu() for k, g in zip(leaves, torch.autograd.grad(
        loss, list(leaves.values())))}


def probe(torch, seed):
    from repro_torch.configs import NANOCHAT_D20, DiLoCoConfig, OptimizerConfig
    from repro_torch.core import DistTrainer, make_strategy
    from repro_torch.models import init_params, lm_loss
    from repro_torch.models.transformer import flatten
    cfg = NANOCHAT_D20.with_(num_layers=2)
    params = flatten(init_params(cfg, seed=seed, device="cpu"))
    g = torch.Generator().manual_seed(11)            # phase 3's tokens
    toks = torch.randint(0, cfg.vocab_size, (2, 2, 257), generator=g,
                         dtype=torch.int32)
    opt_cfg = OptimizerConfig(total_steps=10, warmup_steps=2,
                              fused_adamw=True)
    dcfg = DiLoCoConfig(num_workers=2, h_inner_steps=1)
    data = lambda s: {"tokens": toks[:, :1, :-1], "labels": toks[:, :1, 1:]}
    out = {}
    for dev in ("cpu", "cuda"):
        dt = DistTrainer(lambda pp, b: lm_loss(pp, b, cfg), opt_cfg, dcfg,
                         make_strategy(dcfg))
        p = {k: v.to(dev) for k, v in params.items()}
        state, _ = dt.run(dt.init(p), data, 1)
        out[dev] = {k: v.cpu() for k, v in state.global_params.items()}
        del state
    over, worst = {}, (0.0, None)
    for k, pc in out["cpu"].items():
        d = (out["cuda"][k] - pc).abs()
        scale = float(pc.abs().max())
        rel = float(d.max()) / scale
        worst = max(worst, (rel, k))
        idx = torch.nonzero(d.reshape(-1) > 1e-4 * scale).squeeze(1)
        if idx.numel():
            over[k] = idx
    rec = {"seed": seed, "gate_max": worst[0], "worst_leaf": worst[1],
           "elements_past_gate": {k: int(v.numel()) for k, v in over.items()},
           "workers": []}
    for w in range(2):
        batch = {"tokens": toks[w, :1, :-1], "labels": toks[w, :1, 1:]}
        g32 = grads(torch, params, batch, cfg, "cpu")
        gcu = grads(torch, params, batch, cfg, "cuda")
        g64 = float64_grads(torch, params, batch, cfg)
        wrec = {"grad_rel": max(float((gcu[k] - g32[k]).abs().max())
                                / float(g32[k].abs().max()) for k in g32)}
        for k, idx in over.items():
            a, b, c = (t[k].reshape(-1)[idx] for t in (g32, gcu, g64))
            scale = float(g64[k].abs().max())
            apart = torch.sign(a) != torch.sign(b)
            wrec[k] = {
                "signs_apart": int(apart.sum()),
                "max_abs_grad_over_leaf_max": float(
                    torch.maximum(a.abs(), b.abs()).max()) / scale,
                "cpu_sign_is_f64s": int((torch.sign(a) == torch.sign(c))
                                        [apart].sum()),
                "card_sign_is_f64s": int((torch.sign(b) == torch.sign(c))
                                         [apart].sum()),
                "max_abs_f64_grad_over_leaf_max": float(c.abs().max())
                / scale,
                "examples": [[float(x), float(y), float(z)] for x, y, z in
                             list(zip(a, b, c))[:4]]}
            leaf_apart = (torch.sign(g32[k]) != torch.sign(gcu[k]))
            wrec[k]["signs_apart_in_leaf"] = int(leaf_apart.sum())
        rec["workers"].append(wrec)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", default="0,1,2,3")
    ap.add_argument("--out", default=None)
    ap.add_argument("--shared-state", action="store_true",
                    help="run chip_smoke.py phase 3's step and DiLoCo "
                         "round (gated) at each seed")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("diloco_gate_probe: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    from chip_smoke import SmokeFailure, gpu_line, phase_train_step_vs_cpu
    from repro_torch.kernels import _build
    _build.build()
    recs = []
    for s in map(int, args.seeds.split(",")):
        if args.shared_state:
            print(f"weight seed {s}", flush=True)
            try:
                rec = dict(seed=s, **phase_train_step_vs_cpu(torch, s))
            except SmokeFailure as e:
                print(f"diloco_gate_probe: seed {s}: FAIL: {e}",
                      file=sys.stderr)
                return 1
        else:
            rec = probe(torch, s)
        recs.append(rec)
        print(json.dumps(rec), flush=True)
    print(gpu_line())
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(recs, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
