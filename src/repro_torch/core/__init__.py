"""The training runtime: DiLoCo and DDP through one ``DistTrainer`` loop
(``run_diloco`` / ``run_ddp`` / ``run_streaming_diloco`` wrap it), with
the ``ddp``, ``ddp_compressed``, ``diloco``, ``streaming``,
``overlapped``, ``pipelined``, ``gossip`` and ``async_gossip`` sync
strategies over the codec transport, the fixed, staged and adaptive H
schedules, the drift diagnostics (``drift``), the fault layer
(``faults``: scripted crash / rejoin / drop / slow / kill events, quorum
outer rounds and elastic rejoin), and GRPO, nanochat's optional
policy-gradient stage (``grpo``)."""
from repro_torch.core import drift, outer_opt
from repro_torch.core.ddp import DDPState, DDPTrainer, run_ddp
from repro_torch.core.diloco import DiLoCoState, DiLoCoTrainer, run_diloco
from repro_torch.core.dist_trainer import DistTrainer
from repro_torch.core.faults import (FaultEvent, FaultSchedule, FleetTracker,
                                     RoundInfo, SimulatedCrash)
from repro_torch.core.grpo import GRPOTrainer, arith_reward_fn, grpo_loss
from repro_torch.core.outer_opt import OuterState
from repro_torch.core.schedule import AdaptiveH, FixedH, HSchedule, StagedH
from repro_torch.core.streaming import (StreamingDiLoCoTrainer,
                                        fragment_fraction, fragment_masks,
                                        run_streaming_diloco)
from repro_torch.core.sync import (AsyncGossipSync, CompressedDDPSync,
                                   DDPSync, DiLoCoSync, GossipRound,
                                   GossipSync, OverlappedSync, PipelinedSync,
                                   StreamingSync, SyncEvent, SyncRunner,
                                   SyncStrategy, compressed_ddp_config,
                                   gossip_peers, make_strategy,
                                   register_strategy, strategy_names)
from repro_torch.core.transport import (BF16Cast, Codec, F32Passthrough,
                                        Int8Symmetric, OuterPayload,
                                        Transport, make_codec)

__all__ = ["AdaptiveH", "AsyncGossipSync", "BF16Cast", "Codec",
           "CompressedDDPSync", "DDPState", "DDPSync", "DDPTrainer",
           "DiLoCoState", "DiLoCoSync", "DiLoCoTrainer", "DistTrainer",
           "F32Passthrough", "FaultEvent", "FaultSchedule", "FixedH",
           "FleetTracker", "GRPOTrainer", "GossipRound", "GossipSync",
           "HSchedule", "Int8Symmetric", "OuterPayload", "OuterState",
           "OverlappedSync", "PipelinedSync", "RoundInfo", "SimulatedCrash",
           "StagedH", "StreamingDiLoCoTrainer", "StreamingSync", "SyncEvent",
           "SyncRunner", "SyncStrategy", "Transport", "arith_reward_fn",
           "compressed_ddp_config", "drift", "fragment_fraction",
           "fragment_masks", "gossip_peers", "grpo_loss", "make_codec",
           "make_strategy", "outer_opt", "register_strategy", "run_ddp",
           "run_diloco", "run_streaming_diloco", "strategy_names"]
