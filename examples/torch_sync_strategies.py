"""Compare the sync strategies on one model through the port's runtime
(the PyTorch counterpart of ``examples/sync_strategies.py``).

Trains the same small nanochat-style model under DDP, DiLoCo, Streaming
DiLoCo, Overlapped DiLoCo (delayed outer application + straggler
jitter), pipelined DiLoCo on the int8 wire, gossip and async gossip, all
through the one ``DistTrainer`` loop, then reports per strategy the final
loss, the wire bytes a worker sent (the transport's count), the measured
inner-step seconds, and the wall-clock that the port's comm simulator
(``repro_torch.launch.comm_sim``, host only) models for the run at that
step over its default link (one 100 Gbit/s Ethernet port per worker);
for gossip also the per-pair replay.  ``syncs`` counts rounds (async
gossip: worker applies, which need no common round).  Runs on the card
by default and prints the card's name and power limit.

  PYTHONPATH=src python examples/torch_sync_strategies.py [--device cpu]
"""
import argparse
import subprocess

from repro_torch.configs import DiLoCoConfig, ModelConfig, OptimizerConfig
from repro_torch.core import (AsyncGossipSync, DDPSync, DiLoCoSync,
                              DistTrainer, GossipSync, OverlappedSync,
                              PipelinedSync, StreamingSync, transport)
from repro_torch.data import PackedDataset, synthetic, train_tokenizer
from repro_torch.launch.comm_sim import (default_comm_model,
                                         simulate_gossip, simulate_schedule)
from repro_torch.models import init_params, lm_loss
from repro_torch.models.transformer import flatten
from repro_torch.serving import resolve_device

STEPS = 60
WORKERS = 4
H = 10


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    world = synthetic.World.make(40)
    texts = synthetic.gen_pretrain_texts(world, 2000)
    tok = train_tokenizer(texts[:1000], 512)
    ds = PackedDataset.from_texts(texts, tok, seq_len=64)

    cfg = ModelConfig(name="strategies", num_layers=2, d_model=128,
                      num_heads=4, num_kv_heads=4, d_ff=256,
                      vocab_size=tok.vocab_size)
    params = init_params(cfg, seed=0, device=device)
    n_params = sum(p.numel() for p in flatten(params).values())
    opt = OptimizerConfig(total_steps=STEPS, warmup_steps=5,
                          learning_rate=0.02, adam_lr=1e-3)

    def worker_data(step):
        return ds.worker_batches(step, WORKERS, 4)

    def global_data(step):  # DDP: K=1, merged global batch
        return {k: v[None] for k, v in ds.batch(step, WORKERS * 4).items()}

    dcfg = DiLoCoConfig(num_workers=WORKERS, h_inner_steps=H)
    int8_cfg = DiLoCoConfig(num_workers=WORKERS, h_inner_steps=H,
                            delta_dtype="int8")
    ddp_cfg = DiLoCoConfig(num_workers=1, h_inner_steps=1, outer_lr=1.0,
                           outer_momentum=0.0, nesterov=False)
    runs = [
        ("ddp", DDPSync(), ddp_cfg, global_data),
        ("diloco", DiLoCoSync(), dcfg, worker_data),
        ("streaming", StreamingSync(num_fragments=4), dcfg, worker_data),
        ("overlapped", OverlappedSync(delay=3, jitter=2), dcfg, worker_data),
        # DiLoCoX shape: int8 fragments, one per round, overlapped apply
        ("pipelined8", PipelinedSync(num_fragments=4, delay=3), int8_cfg,
         worker_data),
        ("gossip8", GossipSync(topology="random"), int8_cfg, worker_data),
        ("async8", AsyncGossipSync(jitter=2, staleness_bound=2), int8_cfg,
         worker_data),
    ]
    comm = default_comm_model()
    if device.type == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip())
    print(f"{n_params} params, {STEPS} steps, K {WORKERS}, H {H}, link "
          f"{comm.bandwidth:.4g} B/s + {comm.latency} s a transfer")
    print(f"{'strategy':<11} {'loss':>7} {'syncs':>5} {'sent MB':>8} "
          f"{'step s':>8} {'sched GB':>8} {'modeled wall':>12} "
          f"{'overhead':>8} {'pair wall':>9}")
    for name, strat, c, data in runs:
        trainer = DistTrainer(lambda p, b: lm_loss(p, b, cfg), opt, c, strat)
        transport.reset_shipped()
        state, hist = trainer.run(trainer.init(params), data, STEPS)
        sent = sum(transport.shipped.values()) / c.num_workers
        step_s = hist["step_seconds"]
        events = strat.payload_schedule(n_params, STEPS, c)
        sim = simulate_schedule(events, STEPS, step_s, comm)
        pair = ""
        if hasattr(strat, "gossip_rounds"):
            g = simulate_gossip(
                strat.gossip_rounds(n_params, STEPS, c), STEPS,
                [step_s] * WORKERS, comm,
                staleness_steps=getattr(strat, "staleness_bound", 0))
            pair = f"{g['wall_clock_s']:.3f}s"
        syncs = (len(hist["sync_steps"]) or len(hist["frag_syncs"])
                 or len(hist.get("gossip_syncs", ())))
        print(f"{name:<11} {hist['loss'][-1]:>7.3f} {syncs:>5} "
              f"{sent / 1e6:>8.3f} {step_s:>8.4f} "
              f"{sim['total_bytes'] / 1e9:>8.4f} "
              f"{sim['wall_clock_s']:>11.3f}s "
              f"{100 * sim['overhead_frac']:>7.2f}% {pair:>9}")


if __name__ == "__main__":
    main()
