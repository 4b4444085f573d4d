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

Tensor parallelism and ``fsdp``.  The functions that are not
elementwise take the mesh axes as an argument, ``axis``: a process mesh
whose model axis and/or ``fsdp`` data axis split the leaves
(``launch.mesh.ProcessMesh``: its ``split_dim`` / ``data_split_dim``,
``reduce_leaves``, ``model_all_gather`` / ``data_all_gather`` and
``model_part`` / ``data_part``), or None (whole leaves, no collective).
The trainers that own the mesh pass it in.
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


def global_norm(tree: Flat, axis=None) -> torch.Tensor:
    """sqrt of the sum over leaves, in path order, of each leaf's sum of
    squares in f32 — the JAX package sums its leaves in the same order.
    With an ``axis`` a split leaf's sum of squares is summed over every
    group that splits it, model and/or data (one all-reduce a group for
    all of them, ``reduce_leaves``) and a whole leaf counts once, so
    every rank gets the norm of the whole tree."""
    paths = sorted(tree)
    sqs = [tree[path].float().square().sum() for path in paths]
    if axis is not None:
        sqs = axis.reduce_leaves(paths, sqs)
    total = None
    for sq in sqs:
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def clip_by_global_norm(tree: Flat, max_norm: float, axis=None
                        ) -> Tuple[Flat, torch.Tensor]:
    norm = global_norm(tree, axis)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return {k: g * scale.to(g.dtype) for k, g in tree.items()}, norm


def chain_clip(opt: Optimizer, max_norm: float, axis=None) -> Optimizer:
    """Wrap an optimizer with global-norm gradient clipping."""
    def update(grads, state, params, step):
        grads, _ = clip_by_global_norm(grads, max_norm, axis)
        return opt.update(grads, state, params, step)
    return Optimizer(opt.init, update)
