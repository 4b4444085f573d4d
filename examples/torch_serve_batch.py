"""Batched serving (the PyTorch counterpart of
``examples/serve_batch.py``): briefly pretrain, then serve a ragged batch
of chat requests through the KV-cache engine.  Runs on the card by
default.

  PYTHONPATH=src python examples/torch_serve_batch.py [--device cpu]
"""
import argparse

from repro_torch.configs import DiLoCoConfig, ModelConfig, OptimizerConfig
from repro_torch.core import DiLoCoTrainer, run_diloco
from repro_torch.data import PackedDataset, synthetic, train_tokenizer
from repro_torch.models import init_params, lm_loss
from repro_torch.models.transformer import unflatten
from repro_torch.serving import Engine, resolve_device

STEPS = 100


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    device = resolve_device(ap.parse_args(argv).device)
    world = synthetic.World.make(20)
    texts = synthetic.gen_sft_texts(world, 3000)
    tok = train_tokenizer(texts[:1200], 512)
    ds = PackedDataset.from_texts(texts, tok, seq_len=128)
    cfg = ModelConfig(num_layers=4, d_model=128, num_heads=4, num_kv_heads=4,
                      d_ff=512, vocab_size=tok.vocab_size)
    params = init_params(cfg, seed=0, device=device)
    tr = DiLoCoTrainer(lambda p, b: lm_loss(p, b, cfg),
                       OptimizerConfig(total_steps=STEPS, warmup_steps=10,
                                       learning_rate=0.02, adam_lr=1e-3),
                       DiLoCoConfig(num_workers=2, h_inner_steps=10))
    state = tr.init(params)
    state, hist = run_diloco(
        tr, state, lambda s: ds.worker_batches(s, 2, 8), STEPS)
    print(f"train loss {hist['loss'][0]:.2f} -> {hist['loss'][-1]:.2f}")

    engine = Engine(cfg, unflatten(state.global_params), tok, device=device)
    ents = world.train_entities()[:4]
    requests = [f"<|bos|><|user_start|>what is the color of {e} ?"
                f"<|user_end|><|assistant_start|>" for e in ents]
    requests.append("<|bos|><|user_start|>compute 3 + 4 .<|user_end|>"
                    "<|assistant_start|>")  # ragged batch: shorter prompt
    outs = engine.chat(requests, max_new=16)
    for r, o in zip(requests, outs):
        q = r.split("<|user_start|>")[1].split("<|user_end|>")[0]
        print(f"Q: {q}\nA: {o.split('<|assistant_start|>')[-1].strip()}\n")


if __name__ == "__main__":
    main()
