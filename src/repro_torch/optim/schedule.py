"""Learning-rate schedules: warmup+cosine, WSD (warmup-stable-decay, the
nanochat default), constant — the JAX package's ``optim/schedule.py`` on
0-d tensors: f(step) is computed on the step's device in f32, with the
same operations as the JAX version."""
from __future__ import annotations

import math

import torch


def lr_schedule(kind: str, base_lr: float, total_steps: int,
                warmup_steps: int = 0, final_frac: float = 0.0):
    """Returns f(step) -> lr, a 0-d f32 tensor on step's device."""
    if kind not in ("constant", "cosine", "wsd"):
        raise ValueError(kind)
    total = max(total_steps, 1)
    warm = max(warmup_steps, 0)

    def f(step: torch.Tensor) -> torch.Tensor:
        s = step.float()
        warm_lr = base_lr * torch.clamp((s + 1.0) / max(warm, 1), max=1.0)
        if kind == "constant":
            main = torch.full_like(s, base_lr)
        elif kind == "cosine":
            frac = torch.clamp((s - warm) / max(total - warm, 1), 0.0, 1.0)
            main = final_frac * base_lr + (1 - final_frac) * base_lr * 0.5 * (
                1.0 + torch.cos(math.pi * frac))
        else:
            # stable until 80% of total, then linear decay to final_frac
            decay_start = 0.8 * total
            frac = torch.clamp((s - decay_start)
                               / max(total - decay_start, 1), 0.0, 1.0)
            main = base_lr * (1.0 - (1.0 - final_frac) * frac)
        return torch.where(s < warm, warm_lr, main)

    return f
