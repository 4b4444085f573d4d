"""DiLoCo trainer (the JAX package's ``core/diloco.py``).

    each worker:  H inner steps (nanochat's Muon + AdamW)
    every H:      average parameter deltas, outer Nesterov SGD, re-broadcast

The JAX package stacks the K workers on a leading dim and ``vmap``s one
worker's step.  Here the K workers are a Python loop over separate flat
parameter dicts on one device: a stacked (K, ...) copy would need every
worker's activations and gradients alive at once (about 12 GB per worker
at nanochat-d20 and 4 x 1024 tokens), while the loop frees each worker's
graph before the next worker runs.  The arithmetic of each worker is
the same either way.

Parameters are flat dicts ``{manifest path: tensor}``; the loss function
takes the nested tree (``unflatten``), as ``models.lm_loss`` does.  Worker
parameters are updated IN PLACE by the inner step (the JAX package returns
new arrays), and the outer step writes the new anchor into every worker's
tensors, so a worker holds one copy of its parameters throughout.

The DDP baseline (``core/ddp.py``, and ``DDPSync`` in ``core/sync.py``) is
the same inner step with K = 1 on the global batch.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, NamedTuple, Tuple

import torch

from repro_torch.configs.base import DiLoCoConfig, OptimizerConfig
from repro_torch.core import outer_opt
from repro_torch.core.outer_opt import OuterState
from repro_torch.models.transformer import flatten, unflatten
from repro_torch.optim import Optimizer, apply_updates, nanochat_optimizer

Flat = Dict[str, torch.Tensor]


class DiLoCoState(NamedTuple):
    global_params: Flat        # θ_t — the synchronized snapshot
    outer: OuterState
    worker_params: List[Flat]  # K per-worker copies, updated in place
    inner_opt: List[Any]       # K per-worker inner optimizer states
    inner_step: torch.Tensor   # total inner steps taken (0-d int32)


def worker_step(loss_fn: Callable, opt: Optimizer, params: Flat, opt_state,
                batch: Dict[str, torch.Tensor], step: torch.Tensor
                ) -> Tuple[Any, torch.Tensor]:
    """One inner step of one worker: loss and gradients of ``loss_fn`` at
    ``params`` on ``batch``, the optimizer's update, applied to ``params``
    in place.  The autograd graph is freed before the optimizer runs.
    Returns (new optimizer state, loss as a 0-d tensor on the device)."""
    leaves = {k: p.detach().requires_grad_(True) for k, p in params.items()}
    loss, _ = loss_fn(unflatten(leaves), batch)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    del leaves
    updates, opt_state = opt.update(dict(zip(params, grads)), opt_state,
                                    params, step)
    del grads
    apply_updates(params, updates)
    return opt_state, loss.detach()


@dataclasses.dataclass(frozen=True)
class DiLoCoTrainer:
    """loss_fn(params tree, batch) -> (loss, metrics-dict)."""
    loss_fn: Callable
    opt_cfg: OptimizerConfig
    cfg: DiLoCoConfig

    def _inner_opt(self) -> Optimizer:
        return nanochat_optimizer(self.opt_cfg)

    # -- construction -------------------------------------------------------
    def init(self, params) -> DiLoCoState:
        """``params``: a nested tree (or flat dict); it is copied, never
        written.  All state lives on the parameters' device."""
        outer_opt.require_ported(self.cfg)
        with torch.no_grad():
            anchor = {k: p.detach().clone()
                      for k, p in flatten(params).items()}
            workers = [{k: p.clone() for k, p in anchor.items()}
                       for _ in range(self.cfg.num_workers)]
        inner = self._inner_opt()
        device = next(iter(anchor.values())).device
        return DiLoCoState(
            global_params=anchor,
            outer=outer_opt.init_outer_state(anchor),
            worker_params=workers,
            inner_opt=[inner.init(w) for w in workers],
            inner_step=torch.zeros((), dtype=torch.int32, device=device))

    # -- inner step ----------------------------------------------------------
    def inner_step(self, state: DiLoCoState, batches: Dict[str, torch.Tensor]
                   ) -> Tuple[DiLoCoState, torch.Tensor]:
        """batches: tensors with a leading (K, ...) worker dim.  Runs the
        workers one after another; returns (state, (K,) losses on the
        device)."""
        opt = self._inner_opt()
        new_opt, losses = [], []
        for w, params in enumerate(state.worker_params):
            batch = {k: v[w] for k, v in batches.items()}
            opt_state, loss = worker_step(self.loss_fn, opt, params,
                                          state.inner_opt[w], batch,
                                          state.inner_step)
            new_opt.append(opt_state)
            losses.append(loss)
        return (state._replace(inner_opt=new_opt,
                               inner_step=state.inner_step + 1),
                torch.stack(losses))

    # -- outer step ----------------------------------------------------------
    @torch.no_grad()
    def outer_step(self, state: DiLoCoState) -> DiLoCoState:
        """Average the deltas, outer Nesterov step, and write the new
        anchor into every worker (inner optimizer states stay per worker,
        paper §3)."""
        new_global, new_outer = outer_opt.outer_step(
            state.global_params, state.worker_params, state.outer, self.cfg)
        for params in state.worker_params:
            for k, p in params.items():
                p.copy_(new_global[k])
        return state._replace(global_params=new_global, outer=new_outer)
