"""Serving launcher for the PyTorch port: a request-stream runner over the
continuous-batching engine, with the JAX package's flags and report lines
plus ``--device``.  An arch without a paged cache (``--config
mamba2-1.3b``, or an SSM checkpoint) takes the static-bucket fallback:
requests grouped by ``max_new``, no arrival times, and ``--report``
prints that the report is unavailable.

  # one-shot prompts (stdin also works, one prompt per line)
  PYTHONPATH=src python -m repro_torch.launch.serve --ckpt runs/final \\
      --prompt "what is the color of ent3 ?" --temperature 0.7

  # timestamped request stream; reports per-request latency + tokens/s
  PYTHONPATH=src python -m repro_torch.launch.serve --stream requests.jsonl \\
      --report

``--ckpt`` reads a checkpoint the JAX package saved (``.npz`` + ``.json``
manifest, config from ``.cfg.json``); without it the parameters are random
from ``--seed``.  Stream files are JSONL: {"t": <arrival seconds>,
"prompt": "...", "max_new": N}.  The engine runs on CUDA by default;
``--device cpu`` runs the plain PyTorch path.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def percentile(xs, q):
    """q-th percentile of a list, NaN when empty."""
    return float(np.percentile(np.asarray(xs), q)) if xs else float("nan")


def build_requests(args, tok):
    from repro_torch.serving import Request
    stop = tok.special_id("<|assistant_end|>")
    items = []
    if args.stream:
        with open(args.stream) as f:
            for line in f:
                if line.strip():
                    d = json.loads(line)
                    items.append((float(d.get("t", 0.0)), d["prompt"],
                                  int(d.get("max_new", args.max_new))))
    else:
        prompts = args.prompt or [l.strip() for l in sys.stdin if l.strip()]
        items = [(0.0, p, args.max_new) for p in prompts]
    reqs = []
    for rid, (t, prompt, max_new) in enumerate(items):
        wrapped = (f"<|bos|><|user_start|>{prompt}<|user_end|>"
                   f"<|assistant_start|>")
        reqs.append((prompt, Request(
            rid=rid, prompt=tok.encode(wrapped), max_new=max_new,
            temperature=args.temperature if args.temperature > 0 else 1.0,
            greedy=args.temperature == 0.0, eos_id=stop, arrival=t)))
    return reqs


CONFIGS = ("tiny", "nanochat-d20", "mamba2-1.3b")


def make_config(arch: str, vocab_size: int):
    """``tiny`` (the JAX launcher's tiny-nanochat), ``nanochat-d20`` (the
    paper's model at full width) or ``mamba2-1.3b`` (the SSM at full
    width), at the tokenizer's vocabulary."""
    from repro_torch.configs import MAMBA2_13B, NANOCHAT_D20, ModelConfig
    if arch == "tiny":
        return ModelConfig(name="tiny-nanochat", num_layers=4, d_model=128,
                           num_heads=4, num_kv_heads=4, d_ff=512,
                           vocab_size=vocab_size, tie_embeddings=True)
    if arch == "nanochat-d20":
        return NANOCHAT_D20.with_(vocab_size=vocab_size)
    if arch == "mamba2-1.3b":
        return MAMBA2_13B.with_(vocab_size=vocab_size)
    raise NotImplementedError(f"config {arch!r}: the port has "
                              f"{', '.join(CONFIGS)}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", type=str, default=None)
    ap.add_argument("--config", type=str, default="tiny",
                    help="arch when the checkpoint has no .cfg.json "
                         "metadata: tiny | nanochat-d20 | mamba2-1.3b")
    ap.add_argument("--prompt", action="append", default=[])
    ap.add_argument("--stream", type=str, default=None,
                    help="JSONL request stream with arrival timestamps")
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="0 = greedy; >0 samples at this temperature")
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0,
                    help="seed for fresh-init params "
                         "(ignored once --ckpt loads weights)")
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=512)
    ap.add_argument("--spec-k", type=int, default=0,
                    help="speculative decoding: draft up to K tokens per "
                         "slot per round via prompt-lookup (0 = off)")
    ap.add_argument("--policy",
                    choices=["fifo", "longest_prefill", "cache_aware"],
                    default="fifo")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="share prompt-prefix KV blocks across requests "
                         "via a radix tree")
    ap.add_argument("--prefix-cache-blocks", type=int, default=None,
                    help="LRU bound on resident prefix-cache blocks")
    ap.add_argument("--kv-dtype", type=str, default=None,
                    choices=["bf16", "f32", "int8", "fp8", "fp8_e5m2"],
                    help="KV-pool storage format override: a plain pool "
                         "(bf16, f32) or a quantized one (int8, fp8, "
                         "fp8_e5m2: 1-byte payload + f32 scales)")
    ap.add_argument("--pool-bytes", type=int, default=None,
                    help="size the KV pool by byte budget instead of "
                         "slots x blocks")
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--report", action="store_true",
                    help="print per-request latency + aggregate tokens/s")
    args = ap.parse_args(argv)

    from repro_torch.checkpoint import (load_config, load_pytree,
                                        params_from_numpy)
    from repro_torch.data import build_tokenizer
    from repro_torch.models import init_params
    from repro_torch.serving import Engine, resolve_device

    device = resolve_device(args.device)
    tok = build_tokenizer()
    cfg = load_config(args.ckpt) if args.ckpt else None
    if cfg is not None:
        print(f"# model config from checkpoint metadata: {cfg.name}")
    else:
        cfg = make_config(args.config, tok.vocab_size)
    if args.kv_dtype is not None:
        cfg = cfg.with_(kv_cache_dtype=args.kv_dtype
                        if args.kv_dtype != "f32" else "float32")
    if cfg.vocab_size != tok.vocab_size:
        print(f"# warning: checkpoint vocab {cfg.vocab_size} != pipeline "
              f"tokenizer vocab {tok.vocab_size}", file=sys.stderr)
    if args.ckpt:
        params = params_from_numpy(load_pytree(args.ckpt), cfg, device)
    else:
        params = init_params(cfg, seed=args.seed, device=device)

    engine = Engine(cfg, params, tok, max_len=args.max_len,
                    num_slots=args.slots, block_size=args.block_size,
                    policy=args.policy, spec_k=args.spec_k,
                    pool_bytes=args.pool_bytes,
                    prefix_cache=args.prefix_cache,
                    prefix_cache_blocks=args.prefix_cache_blocks,
                    device=device)
    reqs = build_requests(args, tok)
    if not reqs:
        print("no requests", file=sys.stderr)
        return

    if engine.continuous:
        stats = engine.run([r for _, r in reqs], use_time=True)
        rows = [r.tokens for _, r in reqs]
    else:   # ssm fallback: static buckets, grouped by max_new (the encoded
            # prompt ids go straight through)
        rows = [None] * len(reqs)
        by_mn = {}
        for i, (_, r) in enumerate(reqs):
            by_mn.setdefault(r.max_new, []).append(i)
        for mn, idxs in by_mn.items():
            out = engine.generate(
                [reqs[i][1].prompt for i in idxs], max_new=mn,
                greedy=args.temperature == 0.0,
                temperature=args.temperature or 1.0,
                eos_id=reqs[idxs[0]][1].eos_id)
            for i, row in zip(idxs, out):
                rows[i] = list(row)
        stats = None
        if args.report:
            print("# report unavailable on the static fallback path "
                  "(ssm/hybrid arch): arrival times and per-request "
                  "latency are not modeled", file=sys.stderr)
    for (prompt, r), row in zip(reqs, rows):
        if r.eos_id in row:
            row = row[:row.index(r.eos_id)]
        print(f">>> {prompt}\n{tok.decode(row).strip()}")

    if args.report and stats is not None:
        lats = [r.finish_time - r.arrival for _, r in reqs
                if r.finish_time is not None]
        ttfts = [r.ttft for _, r in reqs if r.first_token_time is not None]
        print(f"# requests={len(reqs)} generated={stats['generated']} "
              f"step_calls={stats['step_calls']} "
              f"prefill_tokens={stats['prefill_tokens']}")
        print(f"# wall={stats['wall']:.3f}s "
              f"tokens_per_s={stats['generated'] / stats['wall']:.1f} "
              f"latency_p50={percentile(lats, 50):.3f}s "
              f"latency_p95={percentile(lats, 95):.3f}s "
              f"ttft_p50={percentile(ttfts, 50):.3f}s "
              f"ttft_p95={percentile(ttfts, 95):.3f}s")
        if "prefix" in stats:
            p = stats["prefix"]
            print(f"# prefix_cache hit_rate={p['hit_rate']:.2f} "
                  f"matched_tokens={p['matched_tokens']} "
                  f"(matched_frac={p['matched_frac']:.2f}) "
                  f"shared_blocks={p['resident_blocks']} "
                  f"forked={p['forked']} "
                  f"bytes_saved={p['bytes_saved']} "
                  f"skipped_prefill_tokens={stats['prefix_skipped_tokens']}")
        if args.spec_k > 0:
            rates = [r.accept_rate for _, r in reqs if r.drafted]
            print(f"# spec_k={args.spec_k} drafted={stats['drafted']} "
                  f"accepted={stats['accepted']} "
                  f"accept_rate={stats['accept_rate']:.3f} "
                  f"accept_rate_p50={percentile(rates, 50):.3f} "
                  f"accept_rate_p95={percentile(rates, 95):.3f} "
                  f"rolled_back={stats['rolled_back']}")
        kv = engine.kv_report()
        print(f"# kv_dtype={kv['kv_cache_dtype']} "
              f"(pool {kv['kv_pool_dtype']}) "
              f"bytes_per_block={kv['bytes_per_block']} "
              f"num_blocks={kv['num_blocks']} "
              f"pool_bytes={kv['pool_bytes']} "
              f"peak_admitted={stats['peak_admitted']}")
        kernels = "cuda" if device.type == "cuda" else "plain"
        print(f"# device={device} kernels={kernels} policy={engine.policy}")


if __name__ == "__main__":
    main()
