"""The training runtime: DiLoCo and DDP through one ``DistTrainer`` loop,
with the ``ddp``, ``ddp_compressed``, ``diloco``, ``streaming``,
``overlapped``, ``pipelined``, ``gossip`` and ``async_gossip`` sync
strategies over the codec transport, the fixed, staged and adaptive H
schedules, the drift diagnostics (``drift``), and the fault layer
(``faults``: scripted crash / rejoin / drop / slow / kill events, quorum
outer rounds and elastic rejoin)."""
from repro_torch.core import drift, outer_opt
from repro_torch.core.ddp import DDPState, DDPTrainer
from repro_torch.core.diloco import DiLoCoState, DiLoCoTrainer
from repro_torch.core.dist_trainer import DistTrainer
from repro_torch.core.faults import (FaultEvent, FaultSchedule, FleetTracker,
                                     RoundInfo, SimulatedCrash)
from repro_torch.core.outer_opt import OuterState
from repro_torch.core.schedule import AdaptiveH, FixedH, HSchedule, StagedH
from repro_torch.core.streaming import StreamingDiLoCoTrainer, fragment_masks
from repro_torch.core.sync import (AsyncGossipSync, CompressedDDPSync,
                                   DDPSync, DiLoCoSync, GossipRound,
                                   GossipSync, OverlappedSync, PipelinedSync,
                                   StreamingSync, SyncEvent, SyncRunner,
                                   SyncStrategy, compressed_ddp_config,
                                   gossip_peers, make_strategy,
                                   strategy_names)
from repro_torch.core.transport import OuterPayload, Transport, make_codec

__all__ = ["AdaptiveH", "AsyncGossipSync", "CompressedDDPSync", "DDPState",
           "DDPSync", "DDPTrainer", "DiLoCoState", "DiLoCoSync",
           "DiLoCoTrainer", "DistTrainer", "FaultEvent", "FaultSchedule",
           "FixedH", "FleetTracker", "GossipRound",
           "GossipSync", "HSchedule", "OuterPayload", "OuterState",
           "OverlappedSync", "PipelinedSync", "RoundInfo", "SimulatedCrash",
           "StagedH",
           "StreamingDiLoCoTrainer", "StreamingSync", "SyncEvent",
           "SyncRunner", "SyncStrategy", "Transport", "compressed_ddp_config",
           "drift", "fragment_masks", "gossip_peers", "make_codec",
           "make_strategy", "outer_opt", "strategy_names"]
