"""Quickstart (the PyTorch counterpart of ``examples/quickstart.py``):
pretrain a tiny nanochat-style model with DiLoCo (4 workers, H=10) on the
synthetic corpus, then chat with it.  Runs on the card by default.

  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse

from repro_torch.configs import DiLoCoConfig, ModelConfig, OptimizerConfig
from repro_torch.core import DiLoCoTrainer, run_diloco
from repro_torch.data import PackedDataset, synthetic, train_tokenizer
from repro_torch.models import init_params, lm_loss
from repro_torch.models.transformer import unflatten
from repro_torch.serving import Engine, resolve_device

STEPS = 120


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    device = resolve_device(ap.parse_args(argv).device)

    # --- data: synthetic "FineWeb-Edu" proxy + BPE trained from scratch ----
    world = synthetic.World.make(40)
    texts = synthetic.gen_pretrain_texts(world, 4000)
    tok = train_tokenizer(texts[:1500], 512)
    ds = PackedDataset.from_texts(texts, tok, seq_len=128)
    print(f"tokenizer vocab={tok.vocab_size}, corpus={ds.num_tokens} tokens")

    # --- model + DiLoCo trainer (paper hyper-parameters, scaled down) ------
    cfg = ModelConfig(name="quickstart", num_layers=4, d_model=128,
                      num_heads=4, num_kv_heads=4, d_ff=512,
                      vocab_size=tok.vocab_size)
    params = init_params(cfg, seed=0, device=device)
    trainer = DiLoCoTrainer(
        lambda p, b: lm_loss(p, b, cfg),
        OptimizerConfig(total_steps=STEPS, warmup_steps=10,
                        learning_rate=0.02, adam_lr=1e-3),
        DiLoCoConfig(num_workers=4, h_inner_steps=10))  # mu=.9, eta=.8 default
    state = trainer.init(params)

    def data(step):
        return ds.worker_batches(step, 4, 8)

    state, hist = run_diloco(trainer, state, data, STEPS)
    print(f"loss {hist['loss'][0]:.3f} -> {hist['loss'][-1]:.3f} "
          f"({len(hist['sync_steps'])} outer syncs, "
          f"{trainer.bytes_per_sync(params)/1e6:.1f} MB per sync vs "
          f"{trainer.ddp_bytes_per_step(params)/1e6:.1f} MB/step under DDP)")

    # --- serve --------------------------------------------------------------
    engine = Engine(cfg, unflatten(state.global_params), tok, device=device)
    prompts = ["<|bos|>the color of ent3 is",
               "<|bos|>12 + 7 ="]
    for p, o in zip(prompts, engine.chat(prompts, max_new=8)):
        print(f"{p!r} -> {o[len(p):]!r}")


if __name__ == "__main__":
    main()
