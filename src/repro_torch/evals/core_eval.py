"""CORE-proxy evaluation: held-out loss / bits-per-token on the pretrain
distribution (the JAX package's ``evals/core_eval.py``).

nanochat's CORE metric is a normalized composite over 22 public benchmarks —
not reproducible offline.  Our proxy keeps the role it plays in the paper
(base-stage quality signal, higher = better) as ``core = exp(-heldout_ce)``,
the per-token prediction probability, plus raw CE and bits-per-token.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import PackedDataset
from repro_torch.models import lm_loss
from repro_torch.models.transformer import Params, flatten


def heldout_metrics(cfg: ModelConfig = None, params: Params = None,
                    ds: PackedDataset = None, batches: int = 8,
                    batch_size: int = 16, seed: int = 4242,
                    engine=None) -> Dict[str, float]:
    """Pass ``engine`` (the serving ``Engine`` used for the generative task
    evals) to score the exact params being served — eval and serving then
    share one model/params stack instead of drifting apart.  The batches
    go to the parameters' device."""
    if engine is not None:
        cfg, params = engine.cfg, engine.params
    if cfg is None or params is None:
        raise TypeError(
            "heldout_metrics: pass cfg+params or engine=")
    if ds is None:
        raise TypeError("heldout_metrics: ds is required")
    device = next(iter(flatten(params).values())).device
    tot, n = 0.0, 0
    with torch.no_grad():
        for i in range(batches):
            b = ds.batch(10_000_000 + i, batch_size, seed=seed)
            b = {k: torch.as_tensor(v).to(device) for k, v in b.items()}
            loss, _ = lm_loss(params, b, cfg)
            tot += float(loss)
            n += 1
    ce = tot / max(n, 1)
    return {"heldout_ce": ce,
            "bits_per_token": ce / math.log(2),
            "core_proxy": math.exp(-ce)}
