"""The training runtime: DiLoCo and DDP through one ``DistTrainer`` loop,
with the ``ddp``, ``ddp_compressed``, ``diloco``, ``streaming``,
``overlapped`` and ``pipelined`` sync strategies over the codec
transport, and the fixed, staged and adaptive H schedules."""
from repro_torch.core.ddp import DDPState, DDPTrainer
from repro_torch.core.diloco import DiLoCoState, DiLoCoTrainer
from repro_torch.core.dist_trainer import DistTrainer
from repro_torch.core.outer_opt import OuterState
from repro_torch.core.schedule import AdaptiveH, FixedH, HSchedule, StagedH
from repro_torch.core.streaming import StreamingDiLoCoTrainer, fragment_masks
from repro_torch.core.sync import (CompressedDDPSync, DDPSync, DiLoCoSync,
                                   OverlappedSync, PipelinedSync,
                                   StreamingSync, SyncEvent, SyncRunner,
                                   SyncStrategy, compressed_ddp_config,
                                   make_strategy, strategy_names)
from repro_torch.core.transport import OuterPayload, Transport, make_codec

__all__ = ["AdaptiveH", "CompressedDDPSync", "DDPState", "DDPSync", "DDPTrainer",
           "DiLoCoState", "DiLoCoSync", "DiLoCoTrainer", "DistTrainer",
           "FixedH", "HSchedule", "OuterPayload", "OuterState", "OverlappedSync",
           "PipelinedSync", "StagedH", "StreamingDiLoCoTrainer", "StreamingSync",
           "SyncEvent", "SyncRunner", "SyncStrategy", "Transport",
           "compressed_ddp_config", "fragment_masks", "make_codec",
           "make_strategy", "strategy_names"]
