"""Adaptive-H ablation (the PyTorch counterpart of
``examples/adaptive_h.py``): the paper's §5 future-work proposal.

Compares fixed-H DiLoCo against the AdaptiveH controller (H shrinks in
critical phases, grows when the loss is flat) at matched total step budget,
reporting final loss and the realized communication volume.  Runs on the
card by default.

  PYTHONPATH=src python examples/torch_adaptive_h.py --steps 160 [--device cpu]
"""
import argparse

from repro_torch.configs import DiLoCoConfig, ModelConfig, OptimizerConfig
from repro_torch.core import AdaptiveH, DiLoCoTrainer, FixedH, run_diloco
from repro_torch.data import PackedDataset, synthetic, train_tokenizer
from repro_torch.models import init_params, lm_loss
from repro_torch.serving import resolve_device


def run(h_schedule, steps, label, device):
    world = synthetic.World.make(40)
    texts = synthetic.gen_pretrain_texts(world, 3000)
    tok = train_tokenizer(texts[:1200], 512)
    ds = PackedDataset.from_texts(texts, tok, seq_len=128)
    cfg = ModelConfig(num_layers=4, d_model=128, num_heads=4, num_kv_heads=4,
                      d_ff=512, vocab_size=tok.vocab_size)
    params = init_params(cfg, seed=0, device=device)
    tr = DiLoCoTrainer(lambda p, b: lm_loss(p, b, cfg),
                       OptimizerConfig(total_steps=steps, warmup_steps=10,
                                       learning_rate=0.02, adam_lr=1e-3),
                       DiLoCoConfig(num_workers=4))
    state = tr.init(params)

    def data(step):
        return ds.worker_batches(step, 4, 8)

    state, hist = run_diloco(tr, state, data, steps, h_schedule=h_schedule)
    syncs = len(hist["sync_steps"])
    mb = syncs * tr.bytes_per_sync(params) / 1e6
    print(f"{label:12s} final loss={hist['loss'][-1]:.4f} "
          f"syncs={syncs} comm={mb:.1f} MB")
    return hist


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=160)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    run(FixedH(20), args.steps, "fixed H=20", device)
    run(FixedH(40), args.steps, "fixed H=40", device)
    run(AdaptiveH(h0=20, h_min=5, h_max=80), args.steps, "adaptive", device)


if __name__ == "__main__":
    main()
