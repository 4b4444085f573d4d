"""nanochat's optimizer split: Muon for transformer weight matrices,
AdamW for embeddings / unembedding / norms / biases (the JAX package's
``optim/combined.py``).  The paper keeps exactly this split inside each
DiLoCo worker."""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.configs.base import OptimizerConfig
from repro_torch.optim.adamw import adamw
from repro_torch.optim.base import Optimizer, clip_by_global_norm
from repro_torch.optim.muon import muon
from repro_torch.optim.schedule import lr_schedule

_ADAM_LEAF_NAMES = {"A_log", "D", "dt_bias", "conv_w", "conv_b", "router",
                    "table", "unembed", "scale", "bias", "norm_scale",
                    "mix_a", "mix_s", "bq", "bk", "bv"}


def partition_label(path: str, leaf: torch.Tensor) -> str:
    """'muon' for true weight matrices, 'adamw' for everything else; path
    is the flat manifest path (``embed/table``, ``layers/attn/wq``)."""
    keys = path.split("/")
    if any(k in _ADAM_LEAF_NAMES for k in keys):
        return "adamw"
    if any(k == "embed" for k in keys):
        return "adamw"
    if leaf.dim() < 2:
        return "adamw"
    return "muon"


def partitioned(opts: dict, label_fn: Callable) -> Optimizer:
    """Route each leaf to the optimizer chosen by ``label_fn(path, leaf)``;
    each optimizer's state holds only the leaves it owns."""
    labels = sorted(opts)

    def split(tree, params):
        return {lab: {k: v for k, v in tree.items()
                      if label_fn(k, params[k]) == lab} for lab in labels}

    def init(params):
        parts = split(params, params)
        return {lab: opts[lab].init(parts[lab]) for lab in labels}

    def update(grads, state, params, step):
        g_parts, p_parts = split(grads, params), split(params, params)
        updates, new_state = {}, {}
        for lab in labels:
            upd, new_state[lab] = opts[lab].update(
                g_parts[lab], state[lab], p_parts[lab], step)
            updates.update(upd)
        return updates, new_state

    return Optimizer(init, update)


def nanochat_optimizer(cfg: OptimizerConfig) -> Optimizer:
    muon_lr = lr_schedule(cfg.schedule, cfg.learning_rate, cfg.total_steps,
                          cfg.warmup_steps, cfg.final_lr_frac)
    adam_lr = lr_schedule(cfg.schedule, cfg.adam_lr, cfg.total_steps,
                          cfg.warmup_steps, cfg.final_lr_frac)
    inner = partitioned(
        {"muon": muon(muon_lr, cfg.muon_momentum, cfg.muon_ns_steps),
         "adamw": adamw(adam_lr, cfg.adam_betas, cfg.adam_eps,
                        cfg.weight_decay, fused=cfg.fused_adamw)},
        partition_label)

    if cfg.grad_clip <= 0:
        return inner

    def update(grads, state, params, step):
        grads, _ = clip_by_global_norm(grads, cfg.grad_clip)
        return inner.update(grads, state, params, step)

    return Optimizer(inner.init, update)
