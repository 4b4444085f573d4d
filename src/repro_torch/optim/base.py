"""Minimal optimizer framework, the JAX package's ``optim/base.py`` shape.

An ``Optimizer`` is a pair of functions on flat parameter dicts
``{path: tensor}`` (paths as in the checkpoint manifest, ``layers/attn/wq``):

  state            = opt.init(params)
  updates, state   = opt.update(grads, state, params, step)
  apply_updates(params, updates)

``step`` is a 0-d int32 tensor on the parameters' device, read by the
schedules and the bias corrections without a host round trip.  Updates
and optimizer states are float32.  ``apply_updates`` adds in place
(``p += u``, the same value as the JAX package's ``p + u``), so a worker
holds one copy of its parameters.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Tuple

import torch

Flat = Dict[str, torch.Tensor]


class Optimizer(NamedTuple):
    init: Callable[[Flat], Any]
    update: Callable[..., Tuple[Flat, Any]]  # (grads, state, params, step)


@torch.no_grad()
def apply_updates(params: Flat, updates: Flat) -> None:
    for path, p in params.items():
        p.add_(updates[path].to(p.dtype))


def global_norm(tree: Flat) -> torch.Tensor:
    """sqrt of the sum over leaves, in path order, of each leaf's sum of
    squares in f32 — the JAX package sums its leaves in the same order."""
    total = None
    for path in sorted(tree):
        sq = tree[path].float().square().sum()
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def clip_by_global_norm(tree: Flat, max_norm: float) -> Tuple[Flat,
                                                               torch.Tensor]:
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return {k: g * scale.to(g.dtype) for k, g in tree.items()}, norm
