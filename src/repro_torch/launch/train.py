"""Training launcher — the paper's pipeline as a CLI (the JAX package's
``launch/train.py``).

Runs the three-stage nanochat pipeline (base pretrain -> dialogue
mid-train -> SFT), with the evals after each stage, under one of:

  --method ddp         fully synchronous baseline (K = 1 on the global
                       batch); with --grad-compress int8|fp8|fp8_e5m2, K
                       workers averaging their per-step updates through
                       that codec (ddp_compressed)
  --method diloco      DiLoCo: K workers, H inner steps of Muon + AdamW,
                       then the outer Nesterov step (--adaptive-h: H from
                       the loss slope, ``core.schedule.AdaptiveH``)
  --method streaming   one of --fragments F fragments every H/F steps
  --method overlapped  the outer update lands --sync-delay steps after the
                       capture; --h-jitter straggler jitter on the capture
  --method pipelined   one fragment per round, applied --sync-delay later
  --method gossip      no all-reduce: each worker averages with one peer
                       a round (--topology ring|random|full)
  --method async_gossip gossip on per-worker clocks (H + jitter_i, from
                       --h-jitter) with a staleness-aware apply rule
                       (--staleness-bound)
  --method hybrid      DiLoCo base, DDP mid + SFT (the paper's hand-off)

    PYTHONPATH=src python -m repro_torch.launch.train --method hybrid \\
        --steps 30 --workers 2 [--delta-dtype int8|fp8|fp8_e5m2|bfloat16] \\
        [--no-error-feedback] [--drift-aware] [--fused-adamw] \\
        [--adaptive-h] [--prefetch N] [--checkpoint-dir DIR \\
        --checkpoint-every N [--resume]] [--worker-speeds 1,1,1.5,2] \\
        [--fault-schedule crash:1@2,rejoin:1@4 [--min-quorum Q]] \\
        [--out-dir DIR] [--device cuda|cpu]

``--steps N`` gives the stages N, N // 2 and N // 2 steps.
``--delta-dtype`` picks the outer-sync wire codec (int8 and fp8 carry
per-tensor scales and an error-feedback residual and run the quantize
kernels on the card; see ``repro_torch.core.transport``).  Runs on the
card by default and raises without one; ``--device cpu`` runs the
kernels' plain PyTorch versions.  The corpora and eval suites are the
synthetic world of ``repro_torch.data.synthetic`` (the same texts,
tokenizer and items as the JAX pipeline's).  The model's vocab is the
tokenizer's; ``--arch nanochat-d20`` runs the JAX package's reduced
variant unless ``--no-reduced`` (the full widths).  ``--prefetch N``
assembles batches N steps ahead on a background thread;
``--checkpoint-dir`` / ``--checkpoint-every`` write crash-consistent run
checkpoints of the base stage, and ``--resume`` continues it bit for bit
from the latest complete one.  ``--worker-speeds`` models a
heterogeneous fleet: after the run, ``comm_report`` replays the base
stage's sync schedule through the comm simulator
(``launch/comm_sim.py``, host only) with per-worker step clocks from the
measured step seconds, and prints the modeled wall-clock of the
homogeneous and the heterogeneous fleet beside the link it assumed.
``--fault-schedule`` (an inline ``core.faults.FaultSchedule`` spec or a
JSON path) scripts worker crashes, rejoins, slowdowns, dropped payloads
and kills in the base stage, whose rounds then average the surviving
workers while at least ``--min-quorum`` contribute; the stage's entry
gains the ``fault``, ``quorum``, ``quorum_skip`` and ``rejoin_drift``
records.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Dict, Optional, Sequence

from repro_torch.configs import get_config, get_reduced
from repro_torch.configs.base import (DiLoCoConfig, ModelConfig,
                                      OptimizerConfig)
from repro_torch.models import init_params


def build_pipeline(vocab_budget: int = 512, seq_len: int = 128,
                   n_pretrain: int = 6000, seed: int = 0):
    """Tokenizer + three-stage datasets + eval suites (synthetic world)."""
    from repro_torch.data import PackedDataset, synthetic, train_tokenizer
    world = synthetic.World.make(40, seed=1234 + seed)
    pre_texts = synthetic.gen_pretrain_texts(world, n_pretrain, seed=seed)
    tok = train_tokenizer(pre_texts[:2000], vocab_budget)
    stages = {
        "base": PackedDataset.from_texts(pre_texts, tok, seq_len),
        "mid": PackedDataset.from_texts(
            synthetic.gen_dialogue_texts(world, n_pretrain // 2, seed=seed + 1),
            tok, seq_len),
        "sft": PackedDataset.from_texts(
            synthetic.gen_sft_texts(world, n_pretrain // 2, seed=seed + 2),
            tok, seq_len),
    }
    suites = {
        "mc": synthetic.gen_mc_eval(world, 32, seed=7),
        "arith": synthetic.gen_arith_eval(32, seed=8),
        "pattern": synthetic.gen_pattern_eval(32, seed=9),
    }
    return world, tok, stages, suites


def make_model(arch: str, reduced: bool, vocab_size: int) -> ModelConfig:
    """``tiny`` (the JAX launcher's tiny nanochat), else the registered
    config (``get_reduced`` when ``reduced``) with the tokenizer's vocab,
    as the JAX launcher builds it."""
    if arch == "tiny":
        return ModelConfig(name="tiny-nanochat", num_layers=4, d_model=128,
                           num_heads=4, num_kv_heads=4, d_ff=512,
                           vocab_size=vocab_size, tie_embeddings=True)
    cfg = get_reduced(arch) if reduced else get_config(arch)
    return cfg.with_(vocab_size=vocab_size)


def run_stage(method: str, cfg: ModelConfig, params, stage_ds, *,
              steps: int, workers: int, per_worker_batch: int, h: int,
              opt_cfg: OptimizerConfig, diloco_cfg: DiLoCoConfig,
              seed: int = 0, h_schedule=None, prefetch: int = 0,
              faults=None, min_quorum: int = 1,
              checkpoint_dir: Optional[str] = None,
              checkpoint_every: int = 0, resume: bool = False):
    """Run one pipeline stage of ``cfg`` from ``params`` (a parameter tree
    on the device to train on) under ``method``; returns (final global
    parameter tree, history).  Every method goes through ``DistTrainer``;
    ``method`` picks the sync strategy; ``h_schedule`` (an ``HSchedule``)
    replaces DiLoCo's fixed H; ``faults`` (a ``FaultSchedule``) and
    ``min_quorum`` reach ``DistTrainer.run``."""
    from repro_torch.core import (DistTrainer, compressed_ddp_config,
                                  make_strategy)
    from repro_torch.models import lm_loss
    from repro_torch.models.transformer import unflatten

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
                          make_strategy(dcfg, h_schedule=h_schedule))
    # the initial state is passed unnamed: ``run`` consumes it, and a name
    # here would keep its K optimizer states alive for the whole run
    state, hist = trainer.run(trainer.init(params), data, steps,
                              prefetch=prefetch, faults=faults,
                              min_quorum=min_quorum,
                              checkpoint_dir=checkpoint_dir,
                              checkpoint_every=checkpoint_every,
                              resume=resume)
    return unflatten(state.global_params), hist


def comm_report(dcfg: DiLoCoConfig, method: str, n_params: int, steps: int,
                h: int, step_time_s: float, worker_speeds: Sequence[float],
                staleness: int = 0, faults=None) -> Dict:
    """Replay the run's sync schedule through the comm simulator: the
    symmetric fleet against one with per-worker step clocks
    (``worker_speeds`` are multipliers on the measured step seconds); the
    gossip strategies also through their per-pair event model.  Host
    only.  ``link_bytes_per_s`` and ``link_latency_s`` name the link every
    modelled wall-clock assumed (``comm_sim.default_comm_model``)."""
    from repro_torch.core import make_strategy
    from repro_torch.launch.comm_sim import (default_comm_model,
                                             simulate_gossip,
                                             simulate_heterogeneous,
                                             simulate_schedule)
    # mirror run_stage's clamping so the replayed schedule is the one the
    # run executed
    delay = min(dcfg.sync_delay, h - 1)
    jitter = min(dcfg.h_jitter, h - 1 - delay)
    dcfg = dataclasses.replace(dcfg, h_inner_steps=h, sync_delay=delay,
                               h_jitter=jitter,
                               strategy=method if method != "hybrid"
                               else "diloco")
    strat = make_strategy(dcfg)
    events = strat.payload_schedule(n_params, steps, dcfg)
    comm = default_comm_model()
    homo = simulate_schedule(events, steps, step_time_s, comm)
    het = simulate_heterogeneous(
        events, steps, [step_time_s * m for m in worker_speeds], comm,
        staleness_steps=staleness, faults=faults)
    report = {"homogeneous": homo, "heterogeneous": het,
              "worker_speeds": list(worker_speeds),
              "step_time_s": step_time_s,
              "link_bytes_per_s": comm.bandwidth,
              "link_latency_s": comm.latency}
    if hasattr(strat, "gossip_rounds"):
        # gossip synchronizes per pair, not per fleet: replay the pair
        # dependencies, so the wall-clock reflects pair barriers
        rounds = strat.gossip_rounds(n_params, steps, dcfg)
        report["gossip"] = simulate_gossip(
            rounds, steps, [step_time_s * m for m in worker_speeds], comm,
            staleness_steps=dcfg.staleness_bound, faults=faults)
    return report


def run_pipeline(method: str = "diloco", arch: str = "tiny",
                 reduced: bool = True, steps: Dict[str, int] = None,
                 workers: int = 4, per_worker_batch: int = 8,
                 seq_len: int = 128, adaptive_h: bool = False,
                 delta_dtype: str = "float32", grad_compress: str = "none",
                 drift_aware: bool = False,
                 sync_delay: int = 0, h_jitter: int = 0,
                 topology: str = "ring", staleness_bound: int = 0,
                 num_fragments: int = 4, error_feedback: bool = True,
                 worker_speeds: Sequence[float] = (),
                 prefetch: int = 0, fused_adamw: bool = False,
                 seed: int = 0, out_dir: Optional[str] = None,
                 eval_after_each_stage: bool = True,
                 fault_schedule: str = "", min_quorum: int = 1,
                 checkpoint_dir: Optional[str] = None,
                 checkpoint_every: int = 0, resume: bool = False,
                 device="cuda") -> Dict:
    """The full three-stage pipeline under one method, on ``device``
    ("cuda", the default, or "cpu").  Returns metrics: per stage the JAX
    package's entry (``loss_first``, ``loss_last``, thinned ``losses``,
    ``method``, ``step_seconds`` and, with ``eval_after_each_stage``,
    ``core`` and ``tasks``) plus ``port``, what the port measures beside
    it (device, kernels, syncs, wire bytes, tokens/s, eval seconds and,
    on the card, peak memory since the stage began).  With ``out_dir`` it
    writes ``{method}_final`` (parameters + ``.cfg.json``) and
    ``{method}_metrics.json`` there.

    ``prefetch`` reaches every stage.  ``checkpoint_dir`` /
    ``checkpoint_every`` / ``resume`` give the BASE stage crash-consistent
    run checkpoints (a rerun with ``resume`` continues bit for bit from
    the latest complete one), as in the JAX package.  ``worker_speeds``
    (one multiplier per worker) adds ``comm_model``, the base stage's
    ``comm_report`` at its measured step seconds (not for ddp).
    ``fault_schedule`` (a ``FaultSchedule.from_spec`` string or a JSON
    path) injects scripted failures into the BASE stage, whose rounds
    need ``min_quorum`` contributors; its entry gains the ``fault``,
    ``quorum``, ``quorum_skip`` and ``rejoin_drift`` records it has."""
    import torch

    from repro_torch.core import AdaptiveH, FaultSchedule, transport
    from repro_torch.evals import chat_suite, heldout_metrics
    from repro_torch.serving import Engine, resolve_device

    faults = FaultSchedule.from_spec(fault_schedule) if fault_schedule \
        else None
    if worker_speeds and method != "ddp" and len(worker_speeds) != workers:
        raise ValueError(f"--worker-speeds needs one multiplier per worker: "
                         f"got {len(worker_speeds)} for {workers} workers")
    device = resolve_device(device)
    steps = steps or {"base": 300, "mid": 120, "sft": 120}
    world, tok, stages, suites = build_pipeline(seq_len=seq_len, seed=seed)
    cfg = make_model(arch, reduced, tok.vocab_size)
    params = init_params(cfg, seed=seed, device=device)

    total = sum(steps.values())
    opt_cfg = OptimizerConfig(total_steps=total, warmup_steps=20,
                              schedule="wsd", learning_rate=0.02,
                              adam_lr=1e-3, fused_adamw=fused_adamw)
    dcfg = DiLoCoConfig(num_workers=workers, delta_dtype=delta_dtype,
                        grad_compress=grad_compress,
                        drift_aware=drift_aware, sync_delay=sync_delay,
                        h_jitter=h_jitter, topology=topology,
                        staleness_bound=staleness_bound,
                        num_fragments=num_fragments,
                        error_feedback=error_feedback, sync_seed=seed)

    # paper §3: H=100 base, H=30 mid/SFT (scaled to our step budget: the
    # ratio sync-count/steps matches — base gets ~3 syncs, mid/sft ~4 each)
    h_by_stage = {"base": max(steps["base"] // 3, 1),
                  "mid": max(steps["mid"] // 4, 1),
                  "sft": max(steps["sft"] // 4, 1)}

    on_card = device.type == "cuda"
    results: Dict = {"method": method, "arch": cfg.name, "stages": {}}
    for stage in ("base", "mid", "sft"):
        stage_method = method
        if method == "hybrid":
            stage_method = "diloco" if stage == "base" else "ddp"
        hs = AdaptiveH(h0=h_by_stage[stage]) if (
            adaptive_h and stage_method == "diloco") else None
        if on_card:
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
        transport.reset_shipped()
        t0 = time.perf_counter()
        # faults, checkpoints and resume target the base stage: the long
        # decentralized pretrain is where workers churn and kills land
        is_base = stage == "base"
        params, hist = run_stage(
            stage_method, cfg, params, stages[stage],
            steps=steps[stage], workers=workers,
            per_worker_batch=per_worker_batch, h=h_by_stage[stage],
            opt_cfg=opt_cfg, diloco_cfg=dcfg, seed=seed, h_schedule=hs,
            prefetch=prefetch,
            faults=faults if is_base else None, min_quorum=min_quorum,
            checkpoint_dir=checkpoint_dir if is_base else None,
            checkpoint_every=checkpoint_every, resume=resume and is_base)
        if on_card:
            torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
        entry = {"loss_first": hist["loss"][0], "loss_last": hist["loss"][-1],
                 "losses": hist["loss"][:: max(1, len(hist["loss"]) // 50)],
                 "method": stage_method,
                 "step_seconds": hist["step_seconds"]}
        for key in ("fault", "quorum", "quorum_skip", "rejoin_drift"):
            if hist.get(key):
                entry[key] = hist[key]
        tokens = steps[stage] * workers * per_worker_batch * seq_len
        port = {"device": device.type,
                "kernels": "cuda" if on_card else "plain",
                "syncs": len(hist["sync_steps"]) + len(hist["frag_syncs"]),
                "wire_bytes": dict(transport.shipped),
                "tokens_per_s": tokens / wall}
        if eval_after_each_stage:
            t1 = time.perf_counter()
            engine = Engine(cfg, params, tok, device=device)
            entry["core"] = heldout_metrics(ds=stages["base"], batches=4,
                                            batch_size=8, engine=engine)
            entry["tasks"] = chat_suite(engine, tok, suites)
            del engine
            if on_card:
                torch.cuda.synchronize(device)
            port["eval_seconds"] = time.perf_counter() - t1
        if on_card:
            port["peak_memory_gb"] = (
                torch.cuda.max_memory_allocated(device) / 1e9)
        entry["port"] = port
        results["stages"][stage] = entry
        print(f"[{method}:{stage}] {cfg.name} device={device.type} "
              f"kernels={port['kernels']} loss {entry['loss_first']:.3f} -> "
              f"{entry['loss_last']:.3f} syncs={port['syncs']} "
              f"wire_bytes={port['wire_bytes']} "
              f"step_seconds={entry['step_seconds']:.4f} "
              f"tokens_per_s={port['tokens_per_s']:.1f} "
              + (f"tasks={entry.get('tasks')}" if eval_after_each_stage
                 else ""), flush=True)

    if worker_speeds and method != "ddp":
        from repro_torch.models.transformer import flatten
        n_params = sum(p.numel() for p in flatten(params).values())
        # staleness stays 0: the schedules' apply_step already carries the
        # strategy's overlap window (sync_delay)
        rep = comm_report(dcfg, method, n_params, steps["base"],
                          h_by_stage["base"],
                          results["stages"]["base"]["step_seconds"],
                          worker_speeds)
        results["comm_model"] = rep
        homo, het = rep["homogeneous"], rep["heterogeneous"]
        pair = ""
        if "gossip" in rep:
            # the fleet-barrier number is the worst case; the per-pair
            # replay is what the gossip runners pay
            pair = (f" pair-barrier wall="
                    f"{rep['gossip']['wall_clock_s']:.2f}s")
        print(f"[comm:{method}/{delta_dtype}] "
              f"bytes={homo['total_bytes']/1e6:.2f}MB/worker "
              f"homogeneous wall={homo['wall_clock_s']:.2f}s "
              f"heterogeneous wall={het['wall_clock_s']:.2f}s "
              f"(straggler adds {het['straggler_s']:.2f}s compute, "
              f"stall {het['stall_s']:.2f}s)" + pair
              + f" link={rep['link_bytes_per_s']:.4g}B/s", flush=True)

    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        from repro_torch.checkpoint import save_config, save_pytree
        ckpt = os.path.join(out_dir, f"{method}_final")
        save_pytree(params, ckpt)
        save_config(cfg, ckpt)   # so serve.py can rebuild the model
        with open(os.path.join(out_dir, f"{method}_metrics.json"), "w") as f:
            json.dump(results, f, indent=1, default=float)
    return results


def main(argv=None) -> Dict:
    from repro_torch.core import strategy_names
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--method", default="diloco",
                    choices=list(strategy_names()) + ["hybrid"])
    ap.add_argument("--arch", default="tiny",
                    choices=["tiny", "nanochat-d20"])
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="--arch nanochat-d20: the JAX package's reduced "
                         "variant (default) or, with --no-reduced, the "
                         "full widths")
    ap.add_argument("--steps", type=int, default=300,
                    help="base-stage steps; mid and SFT take steps // 2")
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--adaptive-h", action="store_true",
                    help="DiLoCo stages: H from the loss slope (AdaptiveH)")
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
                    help="overlapped/async_gossip: max per-worker straggler "
                         "jitter on the capture / the sync period")
    ap.add_argument("--topology", default="ring",
                    choices=["ring", "random", "full"],
                    help="gossip/async_gossip: peer-matching topology "
                         "(full is the DiLoCo mean)")
    ap.add_argument("--staleness-bound", type=int, default=0,
                    help="async_gossip: max staleness (in steps) of a peer "
                         "delta before it is dropped; 0 = synchronous pairs")
    ap.add_argument("--fragments", type=int, default=4,
                    help="streaming/pipelined: number of fragments F")
    ap.add_argument("--worker-speeds", type=str, default="",
                    help="comma list of per-worker relative step-time "
                         "multipliers (heterogeneous fleet); feeds the "
                         "post-run comm-simulator report")
    ap.add_argument("--prefetch", type=int, default=0,
                    help="assemble + device_put batches this many steps "
                         "ahead on a background thread (0 = synchronous)")
    ap.add_argument("--fault-schedule", type=str, default="",
                    help="scripted fault injection for the base stage: an "
                         "inline spec (crash:2@10,rejoin:2@40,kill@90) or a "
                         "JSON file path (core.faults.FaultSchedule)")
    ap.add_argument("--min-quorum", type=int, default=1,
                    help="minimum live contributors for an outer round; "
                         "below it the round is skipped (workers keep "
                         "training locally)")
    ap.add_argument("--checkpoint-dir", type=str, default=None,
                    help="write crash-consistent checkpoints here at outer "
                         "boundaries (base stage)")
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    help="steps between checkpoints (0 = off)")
    ap.add_argument("--resume", action="store_true",
                    help="resume the base stage from the latest complete "
                         "checkpoint in --checkpoint-dir (bit-exact "
                         "continuation)")
    ap.add_argument("--out-dir", type=str, default=None,
                    help="write the final checkpoint and the metrics here")
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    return run_pipeline(method=args.method, arch=args.arch,
                        reduced=args.reduced,
                        steps={"base": args.steps, "mid": args.steps // 2,
                               "sft": args.steps // 2},
                        workers=args.workers, adaptive_h=args.adaptive_h,
                        delta_dtype=args.delta_dtype,
                        grad_compress=args.grad_compress,
                        drift_aware=args.drift_aware,
                        sync_delay=args.sync_delay, h_jitter=args.h_jitter,
                        topology=args.topology,
                        staleness_bound=args.staleness_bound,
                        num_fragments=args.fragments,
                        worker_speeds=tuple(
                            float(x) for x in args.worker_speeds.split(",")
                            if x),
                        error_feedback=not args.no_error_feedback,
                        fused_adamw=args.fused_adamw, seed=args.seed,
                        prefetch=args.prefetch,
                        fault_schedule=args.fault_schedule,
                        min_quorum=args.min_quorum,
                        checkpoint_dir=args.checkpoint_dir,
                        checkpoint_every=args.checkpoint_every,
                        resume=args.resume,
                        out_dir=args.out_dir, device=args.device)


if __name__ == "__main__":
    main()
