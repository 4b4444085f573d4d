"""Synchronization strategies for the ``DistTrainer`` loop — the ``ddp``
and ``diloco`` entries of the JAX package's ``core/sync.py``.

* ``DDPSync``    — K = 1 on the global batch: the worker IS the global
                   model, so there is nothing to exchange (the paper's
                   "Standard DDP" baseline);
* ``DiLoCoSync`` — full delta exchange + outer Nesterov step every H inner
                   steps (paper §2.2), with a fixed H (``FixedH``; the JAX
                   package's ``AdaptiveH`` is not ported).

A strategy's ``bind(engine)`` makes a per-run ``SyncRunner``; the
loop calls ``after_step`` after every inner step.  Between events
``after_step`` is host bookkeeping only; ``next_event(step)`` names the
next step whose ``after_step`` touches device state, so the loop can run
the inner steps up to it without reading anything back.

The other strategies of the JAX registry (``ddp_compressed``,
``streaming``, ``overlapped``, ``pipelined``, ``gossip``,
``async_gossip``) are not ported: ``make_strategy`` raises
``NotImplementedError`` for them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.configs.base import DiLoCoConfig
from repro_torch.core.schedule import FixedH

# history records a runner can emit: (history_key, value) pairs
Records = List[Tuple[str, Any]]


class SyncRunner:
    """Per-run host-side state machine created by ``SyncStrategy.bind``."""

    def after_step(self, state, step: int, loss: float):
        """Called after every inner step; returns (state, records)."""
        return state, []

    def next_event(self, step: int) -> Optional[int]:
        """First step >= ``step`` whose ``after_step`` may touch device
        state; ``None`` = no event before the run ends."""
        return step

    def finalize(self, state, num_steps: int):
        """Called once after the last step; returns (state, records)."""
        return state, []


class SyncStrategy:
    def bind(self, engine) -> SyncRunner:
        raise NotImplementedError


# ---------------------------------------------------------------------------
# DDP — synchronize every step
# ---------------------------------------------------------------------------

class _DDPRunner(SyncRunner):
    def after_step(self, state, step, loss):
        # K=1 + global batch: the worker IS the global model, synchronized
        # by construction — nothing to exchange, just record the cadence.
        return state, [("sync_steps", step)]

    def next_event(self, step):
        return None

    def finalize(self, state, num_steps):
        # the global parameters ARE the worker's (the same tensors)
        return state._replace(global_params=dict(state.worker_params[0])), []


@dataclasses.dataclass(frozen=True)
class DDPSync(SyncStrategy):
    """Fully synchronous baseline: one gradient step on the global batch."""

    def bind(self, engine) -> SyncRunner:
        if engine.cfg.num_workers != 1:
            raise ValueError(
                "DDPSync is the K=1 + global-batch baseline; "
                f"got num_workers={engine.cfg.num_workers}.  Use DiLoCoSync "
                "with H=1 for per-step delta averaging across workers.")
        return _DDPRunner()


# ---------------------------------------------------------------------------
# DiLoCo — full delta exchange every H steps
# ---------------------------------------------------------------------------

class _DiLoCoRunner(SyncRunner):
    def __init__(self, engine, hs: FixedH):
        self.engine = engine
        self.hs = hs
        self.since = 0

    def after_step(self, state, step, loss):
        self.since += 1
        if self.hs.should_sync(step, self.since, loss):
            self.since = 0
            return self.engine.outer_step(state), [("sync_steps", step)]
        return state, []

    def finalize(self, state, num_steps):
        if self.since:  # trailing sync so global_params reflect all work
            self.since = 0
            return (self.engine.outer_step(state),
                    [("sync_steps", num_steps - 1)])
        return state, []

    def next_event(self, step):
        h = int(self.hs.current_h)
        return step + max(h - self.since, 1) - 1


@dataclasses.dataclass(frozen=True)
class DiLoCoSync(SyncStrategy):
    """Paper §2.2: average parameter deltas + outer Nesterov SGD every H
    (``h``, default the config's ``h_inner_steps``)."""
    h: Optional[int] = None

    def bind(self, engine) -> SyncRunner:
        h = self.h or engine.cfg.h_inner_steps
        return _DiLoCoRunner(engine, FixedH(h))


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_STRATEGY_REGISTRY: Dict[str, Any] = {
    "ddp": lambda cfg: DDPSync(),
    "diloco": lambda cfg: DiLoCoSync(),
}
# registered in the JAX package, not ported yet
UNPORTED = ("ddp_compressed", "streaming", "overlapped", "pipelined",
            "gossip", "async_gossip")


def strategy_names() -> Tuple[str, ...]:
    """Ported strategy names."""
    return tuple(_STRATEGY_REGISTRY)


def make_strategy(cfg: DiLoCoConfig) -> SyncStrategy:
    """The strategy ``cfg.strategy`` names."""
    if cfg.strategy in UNPORTED:
        raise NotImplementedError(
            f"strategy {cfg.strategy!r} is not ported; the port has "
            f"{strategy_names()}")
    factory = _STRATEGY_REGISTRY.get(cfg.strategy)
    if factory is None:
        raise ValueError(f"unknown strategy {cfg.strategy!r}; expected one "
                         f"of {strategy_names()}")
    return factory(cfg)
