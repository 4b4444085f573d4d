"""Standard synchronous data-parallel baseline (the paper's "Standard
DDP"; the JAX package's ``core/ddp.py``): one set of parameters, one
gradient over the full global batch every step.  On one device the
gradient of the mean loss over the global batch is what K processes'
all-reduced gradients would be.  ``DistTrainer`` runs DDP as the K = 1
strategy (``core/sync.py`` ``DDPSync``); ``DDPTrainer`` is the same step
on its own, and ``run_ddp`` runs its state through that loop.

Across processes (``replicate_fn=mesh.replicate_fn`` of a (pod 1, data
D) ``launch.mesh`` process mesh) each rank takes its 1/D of the global
batch, and its gradients are all-reduced (mean over the D ranks) before
the optimizer runs, so every rank applies the same update.  On a mesh
whose model axis splits the model (``replicate_fn.tp``) each rank holds
and steps its shards (``core/diloco.py``), and the mean runs over the
data group of its model index.  With ``fsdp`` the data ranks split
the model too (ZeRO-3, ``core/diloco.py``): each rank holds and steps
its shards, the layers gather their weights over the data group, and
a sharded leaf's gradient comes out of the backward already
reduce-scattered."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import DiLoCoConfig, OptimizerConfig
from repro_torch.core import outer_opt
from repro_torch.core.diloco import (DiLoCoState, Flat, own_params,
                                     under_model_axis, worker_step)
from repro_torch.optim import nanochat_optimizer


class DDPState(NamedTuple):
    params: Flat
    opt: Any
    step: torch.Tensor


@dataclasses.dataclass(frozen=True)
class DDPTrainer:
    loss_fn: Callable
    opt_cfg: OptimizerConfig
    replicate_fn: Optional[Callable] = None     # a process mesh's

    def _opt(self):
        return nanochat_optimizer(
            self.opt_cfg, axis=getattr(self.replicate_fn, "sharded", None))

    def init(self, params) -> DDPState:
        own = own_params(params, self.replicate_fn)
        device = next(iter(own.values())).device
        return DDPState(params=own,
                        opt=self._opt().init(own),
                        step=torch.zeros((), dtype=torch.int32,
                                         device=device))

    @under_model_axis
    def train_step(self, state: DDPState, batch: Dict[str, torch.Tensor]
                   ) -> Tuple[DDPState, torch.Tensor]:
        """One step on the global batch (across processes: this rank's
        part of it); parameters update in place."""
        opt_state, loss = worker_step(
            self.loss_fn, self._opt(), state.params,
            state.opt, batch, state.step,
            getattr(self.replicate_fn, "grad_reduce", None))
        return DDPState(state.params, opt_state, state.step + 1), loss


def run_ddp(trainer: DDPTrainer, state: DDPState, data_fn, num_steps: int,
            record_every: int = 1, eval_fn: Optional[Callable] = None,
            eval_every: int = 0) -> Tuple[DDPState, Dict]:
    """data_fn(step) -> merged global batch (no worker dim).

    A thin wrapper over the ``DistTrainer`` runtime: DDP is the K=1
    strategy on the global batch, so the ``DDPState`` is lifted into the
    worker encoding (one worker holding ``state.params`` and
    ``state.opt``), run under ``DDPSync`` and lowered back.  The run
    trains the worker's tensors in place, so the lowered state holds the
    trained parameters and the one passed in is consumed."""
    from repro_torch.core.dist_trainer import DistTrainer
    from repro_torch.core.sync import DDPSync
    dcfg = DiLoCoConfig(num_workers=1, h_inner_steps=1, outer_lr=1.0,
                        outer_momentum=0.0, nesterov=False, strategy="ddp")
    dt = DistTrainer(trainer.loss_fn, trainer.opt_cfg, dcfg, DDPSync(),
                     trainer.replicate_fn)
    lifted = DiLoCoState(
        global_params=dict(state.params),
        outer=outer_opt.init_outer_state(state.params),
        worker_params=[state.params], inner_opt=[state.opt],
        inner_step=state.step)
    lifted, history = dt.run(
        lifted, lambda s: {k: v[None] for k, v in data_fn(s).items()},
        num_steps, record_every=record_every, eval_fn=eval_fn,
        eval_every=eval_every)
    final = DDPState(params=lifted.worker_params[0],
                     opt=lifted.inner_opt[0], step=lifted.inner_step)
    return final, history
