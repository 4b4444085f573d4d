"""Step functions of the launcher and the dry run (the JAX package's
``launch/steps.py``), over the port's trainers and model functions:

* ``make_train_step``   — one synchronous training step (forward,
                          backward, the Muon / AdamW update): DiLoCo's
                          inner step and the DDP step alike (over a
                          process mesh's data axis the gradients are
                          all-reduced first);
* ``make_diloco_steps`` — (inner, outer): the inner step of the workers
                          this process holds (no collective across pods)
                          and the outer round (the delta exchange and the
                          Nesterov update; across pods with a
                          ``replicate_fn``);
* ``make_inner_chunk``  — H inner steps over a (T, K, ...) batch, (T, K)
                          losses: the inner program of one outer round;
* ``make_prefill_step`` — the full-sequence forward, last-position logits;
* ``make_serve_step``   — one-token decode against a static cache.

The reference takes a ``ModelAPI``; the port's model functions take the
config, so these take ``cfg``.  Parameters are flat dicts (train, DiLoCo)
or trees (prefill, serve), as the functions they wrap take them.

Serving over a model axis (``mesh=``, a process mesh of ``model`` > 1):
each model rank runs the prefill and serve steps on its shards
(``models.sharding.serve_layout``: ``shard`` of the parameters, after
``repeat_kv_heads`` where the KV heads repeat) and its part of the cache
(``init_decode_cache(..., mesh=)``), under ``tensor_parallel.use(mesh)``,
and gets back what the reference's partitioned program returns: the
logits of its own vocab columns (``("batch", "vocab")``), and its part of
the cache, updated in place.  ``tensor_parallel.vocab_parallel_argmax``
gives the greedy ids; ``mesh.model_all_gather(logits, -1)`` the whole
logits.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from repro_torch.configs.base import (DiLoCoConfig, ModelConfig,
                                      OptimizerConfig)
from repro_torch.core.ddp import DDPTrainer
from repro_torch.core.diloco import DiLoCoTrainer
from repro_torch.models import decode_step_lm, forward_lm, lm_loss
from repro_torch.models import tensor_parallel as tp


def _loss(cfg: ModelConfig) -> Callable:
    return lambda p, b: lm_loss(p, b, cfg)


def make_train_step(cfg: ModelConfig, opt_cfg: OptimizerConfig,
                    replicate_fn: Optional[Callable] = None) -> Callable:
    """``train_step(state: DDPState, batch) -> (state, loss)``."""
    return DDPTrainer(_loss(cfg), opt_cfg, replicate_fn).train_step


def make_diloco_steps(cfg: ModelConfig, opt_cfg: OptimizerConfig,
                      dcfg: DiLoCoConfig,
                      replicate_fn: Optional[Callable] = None
                      ) -> Tuple[Callable, Callable]:
    """``inner(state, batches (K, ...)) -> (state, (K,) losses)`` and
    ``outer(state) -> state``."""
    trainer = DiLoCoTrainer(_loss(cfg), opt_cfg, dcfg, replicate_fn)
    return trainer.inner_step, trainer.outer_step


def make_inner_chunk(cfg: ModelConfig, opt_cfg: OptimizerConfig,
                     dcfg: DiLoCoConfig,
                     replicate_fn: Optional[Callable] = None) -> Callable:
    """``chunk(state, batches (T, K, ...)) -> (state, (T, K) losses)``:
    the T inner steps of one round, enqueued back to back.  Between pods
    it issues no collective (the inner steps are pod-local)."""
    trainer = DiLoCoTrainer(_loss(cfg), opt_cfg, dcfg, replicate_fn)

    def chunk(state, batches):
        T = next(iter(batches.values())).shape[0]
        losses = []
        for i in range(T):
            state, loss = trainer.inner_step(
                state, {k: v[i] for k, v in batches.items()})
            losses.append(loss)
        return state, torch.stack(losses)

    return chunk


def make_prefill_step(cfg: ModelConfig, mesh=None) -> Callable:
    """``prefill(params, batch) -> (B, V)`` next-token logits of the last
    position; over ``mesh``'s model axis, this rank's (B, V / model) vocab
    columns."""
    @torch.no_grad()
    def prefill(params, batch):
        with tp.use(mesh):
            logits, _ = forward_lm(params, batch, cfg)
        return logits[:, -1, :]

    return prefill


def make_serve_step(cfg: ModelConfig, mesh=None) -> Callable:
    """``serve_step(params, cache, batch) -> ((B, V) logits, cache)``:
    one token a row against the static cache (updated in place); over
    ``mesh``'s model axis, this rank's (B, V / model) vocab columns and
    its part of the cache."""
    @torch.no_grad()
    def serve_step(params, cache, batch):
        with tp.use(mesh):
            logits, cache = decode_step_lm(params, cache, batch, cfg)
        return logits[:, 0, :], cache

    return serve_step
