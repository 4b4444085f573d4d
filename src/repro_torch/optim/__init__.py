"""Optimizers of the training path: nanochat's Muon + AdamW split with
global-norm clipping and the lr schedules, and Nesterov SGD, on flat
parameter dicts."""
from repro_torch.optim.adamw import adamw
from repro_torch.optim.base import (Optimizer, apply_updates, chain_clip,
                                    clip_by_global_norm, global_norm)
from repro_torch.optim.combined import (nanochat_optimizer, partition_label,
                                        partitioned)
from repro_torch.optim.muon import muon, newton_schulz
from repro_torch.optim.schedule import lr_schedule
from repro_torch.optim.sgd_nesterov import sgd_nesterov

__all__ = ["Optimizer", "adamw", "apply_updates", "chain_clip",
           "clip_by_global_norm", "global_norm", "lr_schedule", "muon",
           "nanochat_optimizer", "newton_schulz", "partition_label",
           "partitioned", "sgd_nesterov"]
