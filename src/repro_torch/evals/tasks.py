"""Task evaluations mirroring the paper's Table 1 columns.

| paper        | ours                                     | metric          |
|--------------|------------------------------------------|-----------------|
| MMLU / ARC   | fact multiple-choice (``mc_accuracy``)    | option-logprob  |
| GSM8K        | arithmetic completion (``arith_exact``)   | exact match     |
| HumanEval    | pattern continuation (``pattern_exact``)  | exact match     |
| ChatCORE     | mean of the three chat-format tasks       | composite       |

The JAX package's ``evals/tasks.py`` over the port's ``Engine``: the same
items, max_new, EOS and argmax rule.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from repro_torch.data.tokenizer import BPETokenizer
from repro_torch.serving.engine import Engine


def mc_accuracy(engine: Engine, tok: BPETokenizer, items: List[dict]) -> float:
    rows, spans = [], []
    for it in items:
        prompt = tok.encode(it["prompt"])
        start = len(rows)
        rows.extend((prompt, tok.encode(o + " ")) for o in it["options"])
        spans.append((start, len(rows), it["answer"]))
    scores = engine.score_continuations_batch(rows)   # one forward
    correct = sum(int(int(np.argmax(scores[a:b])) == ans)
                  for a, b, ans in spans)
    return correct / max(len(items), 1)


def _gen_exact(engine: Engine, tok: BPETokenizer, items: List[dict],
               max_new: int = 12) -> float:
    """Generative exact-match evals go through the same scheduler path that
    serves traffic: one request per item, with EOS-based early eviction so
    finished items free their slots for queued ones (``Engine.generate``
    falls back to static buckets for ssm/hybrid archs)."""
    prompts = [tok.encode(it["prompt"]) for it in items]
    rows = engine.generate(prompts, max_new=max_new, greedy=True,
                           eos_id=tok.special_id("<|assistant_end|>"))
    correct = 0
    for row, it in zip(rows, items):
        text = tok.decode(list(row))
        if text.strip().startswith(it["answer"]):
            correct += 1
    return correct / max(len(items), 1)


def arith_exact(engine: Engine, tok: BPETokenizer, items: List[dict]) -> float:
    return _gen_exact(engine, tok, items, max_new=8)


def pattern_exact(engine: Engine, tok: BPETokenizer, items: List[dict]) -> float:
    return _gen_exact(engine, tok, items, max_new=8)


def chat_suite(engine: Engine, tok: BPETokenizer, suites: Dict[str, List[dict]]
               ) -> Dict[str, float]:
    """Run the full Table-1 analogue.  suites keys: mc / mc_heldout / arith /
    pattern (any subset)."""
    out: Dict[str, float] = {}
    if "mc" in suites:
        out["mc"] = mc_accuracy(engine, tok, suites["mc"])
    if "mc_heldout" in suites:
        out["mc_heldout"] = mc_accuracy(engine, tok, suites["mc_heldout"])
    if "arith" in suites:
        out["arith"] = arith_exact(engine, tok, suites["arith"])
    if "pattern" in suites:
        out["pattern"] = pattern_exact(engine, tok, suites["pattern"])
    core_keys = [k for k in ("mc", "arith", "pattern") if k in out]
    if core_keys:
        out["chatcore"] = float(np.mean([out[k] for k in core_keys]))
    return out
