"""End-to-end driver — the paper's Table 1 experiment, in the PyTorch port.

Runs the full nanochat-style pipeline (base pretrain -> dialogue mid-train ->
SFT) under the three configurations (Standard DDP / DiLoCo / Hybrid), with
the CORE proxy and the three task evals after every stage, through
``repro_torch.launch.train.run_pipeline`` (the torch counterpart of
``examples/pipeline_table1.py``).  Runs on the card by default
(``--device cpu`` runs the kernels' plain versions).

  PYTHONPATH=src python examples/torch_pipeline_table1.py --steps 300 \\
      --out runs/torch_table1 [--arch nanochat-d20 --no-reduced] \\
      [--methods ddp,diloco,hybrid] [--fused-adamw] \\
      [--checkpoint-dir DIR --checkpoint-every N [--resume]]

Stages take ``steps``, ``steps // 2`` and ``steps // 2`` steps.  The
scores print as a Table-1-shaped summary, then one line per method and
stage of what the port measured (tokens/s, step seconds, peak memory on
the card, eval seconds); everything goes to ``<out>/table1.json``.
``--checkpoint-dir`` gives each method's base stage run checkpoints in
``<dir>/<method>``, and ``--resume`` continues it from the latest one.
"""
import argparse
import json
import os


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--out", type=str, default="runs/torch_table1")
    ap.add_argument("--methods", type=str, default="ddp,diloco,hybrid")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--arch", default="tiny", choices=["tiny", "nanochat-d20"])
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="--arch nanochat-d20: the reduced variant (default) "
                         "or, with --no-reduced, the full widths")
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--fused-adamw", action="store_true",
                    help="AdamW through the fused kernel")
    ap.add_argument("--checkpoint-dir", type=str, default=None,
                    help="base-stage run checkpoints, one directory per "
                         "method under this one")
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    help="steps between checkpoints (0 = off)")
    ap.add_argument("--resume", action="store_true",
                    help="continue each method's base stage from its latest "
                         "complete checkpoint")
    args = ap.parse_args(argv)

    from repro_torch.launch.train import run_pipeline

    os.makedirs(args.out, exist_ok=True)
    all_results = {}
    for method in args.methods.split(","):
        print(f"=== {method} ===", flush=True)
        ckpt = (os.path.join(args.checkpoint_dir, method)
                if args.checkpoint_dir else None)
        all_results[method] = run_pipeline(
            method=method, arch=args.arch, reduced=args.reduced,
            steps={"base": args.steps, "mid": args.steps // 2,
                   "sft": args.steps // 2},
            workers=args.workers, per_worker_batch=8, seq_len=128,
            fused_adamw=args.fused_adamw, seed=args.seed, out_dir=args.out,
            checkpoint_dir=ckpt, checkpoint_every=args.checkpoint_every,
            resume=args.resume, device=args.device)

    # Table-1-shaped summary
    cols = ["core", "mc", "mc_heldout", "arith", "pattern", "chatcore"]
    print("\nstage   method   " + "  ".join(f"{c:>9s}" for c in cols))
    for stage in ("base", "mid", "sft"):
        for method, res in all_results.items():
            e = res["stages"][stage]
            vals = {"core": e["core"]["core_proxy"], **e["tasks"]}
            print(f"{stage:7s} {method:8s} "
                  + "  ".join(f"{vals.get(c, float('nan')):9.4f}"
                              for c in cols))
    print("\nstage   method   tokens/s  step_s  peak_GB  eval_s")
    for stage in ("base", "mid", "sft"):
        for method, res in all_results.items():
            e = res["stages"][stage]
            p = e["port"]
            print(f"{stage:7s} {method:8s} {p['tokens_per_s']:9.1f} "
                  f"{e['step_seconds']:7.4f} "
                  f"{p.get('peak_memory_gb', float('nan')):8.2f} "
                  f"{p['eval_seconds']:7.2f}")
    with open(os.path.join(args.out, "table1.json"), "w") as f:
        json.dump(all_results, f, indent=1, default=float)
    print(f"\nwritten to {args.out}/table1.json")
    return all_results


if __name__ == "__main__":
    main()
