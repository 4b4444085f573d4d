"""Standard synchronous data-parallel baseline (the paper's "Standard
DDP"; the JAX package's ``core/ddp.py``): one set of parameters, one
gradient over the full global batch every step.  On one device the
gradient of the mean loss over the global batch is what K processes'
all-reduced gradients would be.  ``DistTrainer`` runs DDP as the K = 1
strategy (``core/sync.py`` ``DDPSync``); ``DDPTrainer`` is the same step
on its own."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Tuple

import torch

from repro_torch.configs.base import OptimizerConfig
from repro_torch.core.diloco import Flat, worker_step
from repro_torch.models.transformer import flatten
from repro_torch.optim import nanochat_optimizer


class DDPState(NamedTuple):
    params: Flat
    opt: Any
    step: torch.Tensor


@dataclasses.dataclass(frozen=True)
class DDPTrainer:
    loss_fn: Callable
    opt_cfg: OptimizerConfig

    def init(self, params) -> DDPState:
        with torch.no_grad():
            own = {k: p.detach().clone() for k, p in flatten(params).items()}
        device = next(iter(own.values())).device
        return DDPState(params=own,
                        opt=nanochat_optimizer(self.opt_cfg).init(own),
                        step=torch.zeros((), dtype=torch.int32,
                                         device=device))

    def train_step(self, state: DDPState, batch: Dict[str, torch.Tensor]
                   ) -> Tuple[DDPState, torch.Tensor]:
        """One step on the global batch; parameters update in place."""
        opt_state, loss = worker_step(self.loss_fn,
                                      nanochat_optimizer(self.opt_cfg),
                                      state.params, state.opt, batch,
                                      state.step)
        return DDPState(state.params, opt_state, state.step + 1), loss
