"""GRPO stage (the PyTorch counterpart of ``examples/grpo_arith.py``):
nanochat's optional reward-model-free RL on GSM8K, reproduced on the
synthetic arithmetic task: SFT a tiny model first, then improve
arithmetic exact-match with group-relative policy gradients.  Runs on the
card by default.

  PYTHONPATH=src python examples/torch_grpo_arith.py --iters 10 [--device cpu]
"""
import argparse

from repro_torch.configs import DiLoCoConfig, ModelConfig, OptimizerConfig
from repro_torch.core import (DiLoCoTrainer, GRPOTrainer, arith_reward_fn,
                              run_diloco)
from repro_torch.data import PackedDataset, synthetic, train_tokenizer
from repro_torch.models import init_params, lm_loss
from repro_torch.models.transformer import unflatten
from repro_torch.serving import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--sft-steps", type=int, default=150)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    world = synthetic.World.make(20)
    sft_texts = synthetic.gen_sft_texts(world, 4000)
    tok = train_tokenizer(sft_texts[:1500], 512)
    ds = PackedDataset.from_texts(sft_texts, tok, seq_len=96)
    cfg = ModelConfig(num_layers=4, d_model=128, num_heads=4, num_kv_heads=4,
                      d_ff=512, vocab_size=tok.vocab_size)
    params = init_params(cfg, seed=0, device=device)

    # --- SFT warm start (DiLoCo, as the paper's pipeline would) -----------
    tr = DiLoCoTrainer(lambda p, b: lm_loss(p, b, cfg),
                       OptimizerConfig(total_steps=args.sft_steps,
                                       warmup_steps=10, learning_rate=0.02,
                                       adam_lr=1e-3),
                       DiLoCoConfig(num_workers=2, h_inner_steps=15))
    st = tr.init(params)
    st, hist = run_diloco(tr, st, lambda s: ds.worker_batches(s, 2, 8),
                          args.sft_steps)
    params = unflatten(st.global_params)
    print(f"SFT loss {hist['loss'][0]:.2f} -> {hist['loss'][-1]:.2f}")

    # --- GRPO on arithmetic -------------------------------------------------
    items = synthetic.gen_arith_eval(16, seed=31)
    prompts = [tok.encode(it["prompt"]) for it in items]
    reward = arith_reward_fn(tok, items)
    grpo = GRPOTrainer(cfg,
                       OptimizerConfig(total_steps=args.iters,
                                       warmup_steps=0, schedule="constant",
                                       learning_rate=0.01, adam_lr=1e-3),
                       group_size=8, max_new=6)
    state = grpo.init(params)
    for it in range(args.iters):
        state, loss, mean_r = grpo.rollout_and_step(
            state, prompts, reward, pad_id=tok.pad, seed=it)
        print(f"iter {it:2d} loss {loss:+.4f} mean_reward {mean_r:.3f}")


if __name__ == "__main__":
    main()
