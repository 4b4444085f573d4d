"""The training runtime: DiLoCo and DDP through one ``DistTrainer`` loop,
with the ``ddp`` and ``diloco`` sync strategies."""
from repro_torch.core.ddp import DDPState, DDPTrainer
from repro_torch.core.diloco import DiLoCoState, DiLoCoTrainer
from repro_torch.core.dist_trainer import DistTrainer
from repro_torch.core.outer_opt import OuterState
from repro_torch.core.schedule import FixedH
from repro_torch.core.sync import (DDPSync, DiLoCoSync, SyncRunner,
                                   SyncStrategy, make_strategy,
                                   strategy_names)

__all__ = ["DDPState", "DDPSync", "DDPTrainer", "DiLoCoState", "DiLoCoSync",
           "DiLoCoTrainer", "DistTrainer", "FixedH", "OuterState",
           "SyncRunner", "SyncStrategy", "make_strategy", "strategy_names"]
