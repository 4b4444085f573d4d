"""Synchronization strategies for the ``DistTrainer`` loop (the JAX
package's ``core/sync.py``):

* ``DDPSync``           — K = 1 on the global batch: the worker IS the
                          global model (the paper's "Standard DDP");
* ``CompressedDDPSync`` — K workers averaging their one-step parameter
                          updates through the codec every step
                          (``--grad-compress``); with a lossless codec it
                          is per-step delta-averaged DDP;
* ``DiLoCoSync``        — full delta exchange + outer Nesterov step every
                          H inner steps (paper §2.2), fixed H or any
                          ``HSchedule`` (``AdaptiveH``);
* ``StreamingSync``     — one fragment every H/F steps, staggered
                          (Streaming DiLoCo, arXiv:2501.18512);
* ``OverlappedSync``    — the delta captured at t is applied at t+delay,
                          with per-worker straggler jitter on the capture;
* ``PipelinedSync``     — one fragment per round, captured at the
                          boundary and applied ``delay`` steps later (the
                          DiLoCoX shape, arXiv:2506.21263).

Every exchange goes through the codec transport (``core/transport.py``);
runners hold the codec's per-worker error-feedback residual (made by
``engine.init_residual``; None for lossless codecs or with error feedback
off).  The fault-aware quorum variants of the reference belong to the
fault layer, which is not ported.

A strategy's ``bind(engine, params)`` makes a per-run ``SyncRunner``; the
loop calls ``after_step`` after every inner step, ``refresh`` before an
eval hook reads ``global_params``, and ``checkpoint_extras`` /
``load_extras`` to save and restore what a resume needs beyond the state
(the residual and the round counters; None while a snapshot is in
flight).  Between events
``after_step`` is host bookkeeping only; ``next_event(step)`` names the
next step whose ``after_step`` touches device state (a sync, a snapshot,
a delayed apply), so the loop can run the inner steps up to it without
reading anything back.  ``payload_schedule(n_params, num_steps, cfg)`` is
the strategy's communication footprint, in the wire bytes each worker
moves per hop (``hop_bytes_per_worker``), host-side only.

The gossip strategies of the JAX registry (``gossip``, ``async_gossip``)
are not ported: ``make_strategy`` raises ``NotImplementedError`` for
them.
"""
from __future__ import annotations

import dataclasses
import random as _pyrandom
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.configs.base import DiLoCoConfig
from repro_torch.core.schedule import FixedH, HSchedule
from repro_torch.core.transport import make_codec

# history records a runner can emit: (history_key, value) pairs
Records = List[Tuple[str, Any]]


@dataclasses.dataclass(frozen=True)
class SyncEvent:
    """One cross-worker payload on the slow (inter-pod) boundary.
    ``step`` is the inner step after which it leaves the worker,
    ``apply_step`` the step by which it must have landed (later than
    ``step`` for overlapped strategies); ``codec`` names the wire codec."""
    step: int
    bytes_per_worker: int
    kind: str                   # "grads" | "delta" | "fragment"
    apply_step: int
    fragment: int = -1
    codec: str = "f32"


def hop_bytes_per_worker(payload_bytes: int, k: int, collective: str) -> int:
    """Bytes ONE worker moves over its boundary link for one sync hop:
    ``gather`` (codec'd payloads carry per-worker scales, so every worker
    receives the other K-1 rows), ``reduce`` (summable f32: ring
    all-reduce, 2(K-1)/K of the payload) or ``peer`` (one payload)."""
    if collective == "gather":
        return payload_bytes * max(k - 1, 1)
    if collective == "reduce":
        if k <= 1:
            return payload_bytes
        return int(payload_bytes * 2 * (k - 1) / k)
    if collective == "peer":
        return payload_bytes
    raise ValueError(f"unknown collective {collective!r}; "
                     "expected gather | reduce | peer")


def _copy_rows(params, sel=None):
    """A fresh copy of one worker's tensors (or of the slices ``sel``
    names): a snapshot must not alias tensors the inner steps update in
    place."""
    if sel is None:
        return {k: t.clone() for k, t in params.items()}
    return {k: params[k][sl].clone() for k, sl in sel.items()
            if sl is not None}


class SyncRunner:
    """Per-run host-side state machine created by ``SyncStrategy.bind``."""

    def after_step(self, state, step: int, loss: float):
        """Called after every inner step; returns (state, records)."""
        return state, []

    def next_event(self, step: int) -> Optional[int]:
        """First step >= ``step`` whose ``after_step`` may touch device
        state; ``None`` = no event before the run ends."""
        return step

    def refresh(self, state):
        """Bring ``global_params`` up to date for an observer (the eval
        hook); identity for strategies that keep it current at every
        sync."""
        return state

    def finalize(self, state, num_steps: int):
        """Called once after the last step; returns (state, records)."""
        return state, []

    # -- run checkpoints ----------------------------------------------------
    def checkpoint_extras(self) -> Optional[Tuple[Any, Dict]]:
        """What a resume needs beyond the state: ``(tensors, meta)``, where
        ``tensors`` is a tree of tensors (the codec's error-feedback
        residual) and ``meta`` JSON-serializable host state (round
        counters).  None when the runner is mid-round (a snapshot in
        flight) and a checkpoint here could not be resumed: the loop
        defers to the next clean chunk boundary.  The base runner holds
        nothing, so every boundary is clean."""
        return {}, {}

    def load_extras(self, arrays, meta: Dict) -> None:
        """Restore what ``checkpoint_extras`` captured; ``arrays`` is None
        when the checkpoint carried no tensors."""
        return None


class SyncStrategy:
    name = "base"

    def bind(self, engine, params) -> SyncRunner:
        """The per-run state machine; ``params`` are the flat global
        parameters (they shape the residual and the fragments)."""
        raise NotImplementedError

    def payload_schedule(self, n_params: int, num_steps: int,
                         cfg: DiLoCoConfig) -> List[SyncEvent]:
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

    def refresh(self, state):
        # the global parameters ARE the worker's (the same tensors)
        return state._replace(global_params=dict(state.worker_params[0]))

    def finalize(self, state, num_steps):
        return self.refresh(state), []


@dataclasses.dataclass(frozen=True)
class DDPSync(SyncStrategy):
    """Fully synchronous baseline: one gradient step on the global batch."""
    name = "ddp"

    def bind(self, engine, params) -> SyncRunner:
        if engine.cfg.num_workers != 1:
            raise ValueError(
                "DDPSync is the K=1 + global-batch baseline; "
                f"got num_workers={engine.cfg.num_workers}.  Use DiLoCoSync "
                "with H=1 for per-step delta averaging across workers.")
        return _DDPRunner()

    def payload_schedule(self, n_params, num_steps, cfg):
        # fp32 grads are summable: ring all-reduce, every step, blocking
        b = hop_bytes_per_worker(4 * n_params, cfg.num_workers, "reduce")
        return [SyncEvent(step=s, bytes_per_worker=b, kind="grads",
                          apply_step=s) for s in range(num_steps)]


# ---------------------------------------------------------------------------
# DiLoCo — full delta exchange every H steps
# ---------------------------------------------------------------------------

class _DiLoCoRunner(SyncRunner):
    def __init__(self, engine, params, hs: HSchedule):
        self.engine = engine
        self.hs = hs
        self.since = 0
        self.residual = engine.init_residual(params)

    def _sync(self, state, step):
        state, self.residual = self.engine.outer_step_ef(state,
                                                         self.residual)
        return state, [("sync_steps", step)]

    def after_step(self, state, step, loss):
        self.since += 1
        if self.hs.should_sync(step, self.since, loss):
            self.since = 0
            return self._sync(state, step)
        return state, []

    def finalize(self, state, num_steps):
        if self.since:  # trailing sync so global_params reflect all work
            self.since = 0
            return self._sync(state, num_steps - 1)
        return state, []

    def checkpoint_extras(self):
        if self.since:
            # mid-round: ``since`` (and AdaptiveH's loss window) are not
            # saved, so defer to the outer boundary, where both are fresh
            return None
        return {"residual": self.residual}, {}

    def load_extras(self, arrays, meta):
        if arrays is not None:
            self.residual = arrays["residual"]

    def next_event(self, step):
        # syncs fire when since_sync reaches the schedule's current H, and
        # every HSchedule here changes H only at a sync (AdaptiveH's loss
        # window is fed per step by after_step, but its slope check runs
        # at the boundary), so the next boundary is known in advance
        h = int(self.hs.current_h)
        return step + max(h - self.since, 1) - 1


@dataclasses.dataclass(frozen=True)
class DiLoCoSync(SyncStrategy):
    """Paper §2.2: average parameter deltas + outer Nesterov SGD every H.

    ``h`` overrides the config's ``h_inner_steps``; ``h_schedule`` plugs in
    any ``HSchedule`` (e.g. ``AdaptiveH``) instead of fixed H."""
    name = "diloco"
    h: Optional[int] = None
    h_schedule: Optional[HSchedule] = None

    def bind(self, engine, params) -> SyncRunner:
        hs = self.h_schedule or FixedH(self.h or engine.cfg.h_inner_steps)
        return _DiLoCoRunner(engine, params, hs)

    def payload_schedule(self, n_params, num_steps, cfg):
        h = self.h or cfg.h_inner_steps
        codec = make_codec(cfg.delta_dtype)
        b = hop_bytes_per_worker(codec.schedule_bytes(n_params),
                                 cfg.num_workers, "gather")
        return [SyncEvent(step=s, bytes_per_worker=b, kind="delta",
                          apply_step=s, codec=codec.name)
                for s in range(h - 1, num_steps, h)]


# ---------------------------------------------------------------------------
# Compressed DDP — per-step update exchange through a lossy codec
# ---------------------------------------------------------------------------

def compressed_ddp_config(cfg: DiLoCoConfig) -> DiLoCoConfig:
    """Fold ``cfg.grad_compress`` into a per-step delta-exchange config:
    H=1 with the identity outer update (lr 1, no momentum) makes the outer
    step "average the workers' one-step parameter updates", through the
    codec (and its error-feedback residual) of ``grad_compress``."""
    codec = cfg.grad_compress if cfg.grad_compress not in ("", "none") \
        else "float32"
    return dataclasses.replace(
        cfg, strategy="ddp_compressed", h_inner_steps=1, outer_lr=1.0,
        outer_momentum=0.0, nesterov=False, delta_dtype=codec)


@dataclasses.dataclass(frozen=True)
class CompressedDDPSync(SyncStrategy):
    """DDP with compressed per-step exchange: K workers average their
    one-step parameter updates through the configured codec every step.
    Build the config with ``compressed_ddp_config``; ``bind`` rejects a
    non-identity outer update."""
    name = "ddp_compressed"

    def bind(self, engine, params) -> SyncRunner:
        cfg = engine.cfg
        if cfg.outer_lr != 1.0 or cfg.outer_momentum != 0.0 or cfg.nesterov:
            raise ValueError(
                "CompressedDDPSync needs the identity outer update "
                "(outer_lr=1, outer_momentum=0, nesterov=False) — build the "
                "config with sync.compressed_ddp_config(); got "
                f"lr={cfg.outer_lr} mu={cfg.outer_momentum} "
                f"nesterov={cfg.nesterov}")
        return _DiLoCoRunner(engine, params, FixedH(1))

    def payload_schedule(self, n_params, num_steps, cfg):
        codec = make_codec(cfg.delta_dtype if cfg.strategy == "ddp_compressed"
                           else (cfg.grad_compress
                                 if cfg.grad_compress not in ("", "none")
                                 else "float32"))
        b = hop_bytes_per_worker(codec.schedule_bytes(n_params),
                                 cfg.num_workers, "gather")
        return [SyncEvent(step=s, bytes_per_worker=b, kind="grads",
                          apply_step=s, codec=codec.name)
                for s in range(num_steps)]


# ---------------------------------------------------------------------------
# Streaming DiLoCo — one fragment every H/F steps, staggered
# ---------------------------------------------------------------------------

class _StreamingRunner(SyncRunner):
    def __init__(self, engine, params):
        from repro_torch.core.streaming import fragment_masks
        self.engine = engine
        self.F = engine.num_fragments
        self.masks = fragment_masks(params, self.F)
        self.period = engine.fragment_schedule()
        self.residual = engine.init_residual(params)

    def after_step(self, state, step, loss):
        if (step + 1) % self.period == 0:
            f = ((step + 1) // self.period - 1) % self.F
            state, self.residual = self.engine.outer_step_fragment_ef(
                state, self.masks[f], self.residual)
            return state, [("frag_syncs", (step, f))]
        return state, []

    def checkpoint_extras(self):
        # the fragment slot is a function of the step alone and the
        # un-synced divergence lives in the state: every boundary is clean
        return {"residual": self.residual}, {}

    def load_extras(self, arrays, meta):
        if arrays is not None:
            self.residual = arrays["residual"]

    def next_event(self, step):
        # fragment boundaries: every step s with (s + 1) % period == 0
        return (step // self.period + 1) * self.period - 1


@dataclasses.dataclass(frozen=True)
class StreamingSync(SyncStrategy):
    """Fragment-wise staggered sync (arXiv:2501.18512): every parameter
    still syncs each H, but instantaneous bandwidth demand drops F×."""
    name = "streaming"
    num_fragments: int = 4

    def bind(self, engine, params) -> SyncRunner:
        return _StreamingRunner(engine, params)

    def payload_schedule(self, n_params, num_steps, cfg):
        h = cfg.h_inner_steps
        period = max(h // self.num_fragments, 1)
        codec = make_codec(cfg.delta_dtype)
        b = hop_bytes_per_worker(
            codec.schedule_bytes(n_params // self.num_fragments),
            cfg.num_workers, "gather")
        return [SyncEvent(step=s, bytes_per_worker=b, kind="fragment",
                          # a fragment may stream until its next slot
                          apply_step=s + period - 1,
                          fragment=((s + 1) // period - 1) % self.num_fragments,
                          codec=codec.name)
                for s in range(period - 1, num_steps, period)]


# ---------------------------------------------------------------------------
# Overlapped DiLoCo — delta captured at t, outer update applied at t+delay
# ---------------------------------------------------------------------------

class _OverlappedRunner(SyncRunner):
    """Captures per-worker snapshots (with straggler jitter) at each round
    boundary and applies the outer update ``delay`` steps later, carrying
    forward the inner progress made meanwhile: worker i becomes new
    anchor + (w_now_i − snap_i).  With delay=0 and jitter=0 this is
    exactly ``DiLoCoSync``.  The jitter draws come from
    ``random.Random(seed)`` in the reference's order, so the snapshot
    steps are the reference's."""

    def __init__(self, engine, params, h: int, delay: int, jitter: int,
                 seed: int):
        if not 0 <= delay < h:
            raise ValueError(f"need 0 <= delay < h, got delay={delay} h={h}")
        if jitter < 0 or jitter + delay >= h:
            raise ValueError(
                f"need jitter + delay < h so every snapshot lands after the "
                f"previous apply, got jitter={jitter} delay={delay} h={h}")
        self.engine = engine
        self.h, self.delay, self.jitter = h, delay, jitter
        self.k = engine.cfg.num_workers
        self.seed = seed
        self.rng = _pyrandom.Random(seed)
        self.round_end = h - 1
        self.snap_steps = self._draw_snap_steps()
        self.buf: Optional[list] = None    # snapshot being filled
        self.pending: Optional[list] = None  # frozen snapshot awaiting apply
        self.pending_apply = -1
        self.residual = engine.init_residual(params)

    def _draw_snap_steps(self) -> Dict[int, int]:
        """Worker i's delta leaves jitter_i steps before the boundary — a
        straggler's contribution reflects fewer inner steps."""
        return {i: self.round_end
                - (self.rng.randint(0, self.jitter) if self.jitter else 0)
                for i in range(self.k)}

    def _apply(self, state):
        state, self.residual = self.engine.sync(state, self.residual,
                                                snapshot=self.pending)
        self.pending = None
        return state

    def after_step(self, state, step, loss):
        records: Records = []
        due = [i for i, s in self.snap_steps.items() if s == step]
        if due:
            if self.buf is None:
                self.buf = [None] * self.k
            for i in due:
                self.buf[i] = _copy_rows(state.worker_params[i])
        if step == self.round_end:
            # every worker's snap step is <= round_end, so buf is full
            self.pending = self.buf
            self.pending_apply = step + self.delay
            self.buf = None
            self.round_end += self.h
            self.snap_steps = self._draw_snap_steps()
        if self.pending is not None and step >= self.pending_apply:
            state = self._apply(state)
            records.append(("sync_steps", step))
        return state, records

    def next_event(self, step):
        cands = [s for s in self.snap_steps.values() if s >= step]
        cands.append(self.round_end)
        if self.pending is not None:
            cands.append(max(self.pending_apply, step))
        return min(cands)

    def finalize(self, state, num_steps):
        records: Records = []
        if self.pending is not None:  # flush the in-flight round
            state = self._apply(state)
            records.append(("sync_steps", num_steps - 1))
        if num_steps % self.h:        # trailing partial round: full sync
            state, self.residual = self.engine.outer_step_ef(state,
                                                             self.residual)
            records.append(("sync_steps", num_steps - 1))
        return state, records

    def checkpoint_extras(self):
        if self.pending is not None or self.buf is not None:
            return None     # snapshot in flight: defer to a clean boundary
        return {"residual": self.residual}, {"round_end": self.round_end}

    def load_extras(self, arrays, meta):
        if arrays is not None:
            self.residual = arrays["residual"]
        # replay the jitter draws so the random stream continues as it
        # would have without the restart
        self.rng = _pyrandom.Random(self.seed)
        self.round_end = self.h - 1
        self.snap_steps = self._draw_snap_steps()
        while self.round_end < int(meta["round_end"]):
            self.round_end += self.h
            self.snap_steps = self._draw_snap_steps()


@dataclasses.dataclass(frozen=True)
class OverlappedSync(SyncStrategy):
    """Streaming DiLoCo's overlapping communication for the full delta:
    capture at t, apply at t+delay, with per-worker straggler jitter
    (``seed`` makes the draws reproducible; ``make_strategy`` threads
    ``DiLoCoConfig.sync_seed`` here)."""
    name = "overlapped"
    h: Optional[int] = None
    delay: int = 0
    jitter: int = 0
    seed: int = 0

    def bind(self, engine, params) -> SyncRunner:
        return _OverlappedRunner(engine, params,
                                 self.h or engine.cfg.h_inner_steps,
                                 self.delay, self.jitter, self.seed)

    def payload_schedule(self, n_params, num_steps, cfg):
        h = self.h or cfg.h_inner_steps
        codec = make_codec(cfg.delta_dtype)
        b = hop_bytes_per_worker(codec.schedule_bytes(n_params),
                                 cfg.num_workers, "gather")
        return [SyncEvent(step=s, bytes_per_worker=b, kind="delta",
                          apply_step=s + self.delay, codec=codec.name)
                for s in range(h - 1, num_steps, h)]


# ---------------------------------------------------------------------------
# Pipelined (DiLoCoX) — ONE fragment per round, delayed apply
# ---------------------------------------------------------------------------

class _PipelinedRunner(SyncRunner):
    """One fragment per outer round: at each H boundary the round's
    fragment (round mod F) is snapshotted, its encoded delta crosses the
    boundary while inner compute continues, and the outer update lands
    ``delay`` steps later, carrying forward the progress made in flight
    on the fragment's slots.  With F=1, delay=0 this is exactly
    ``DiLoCoSync``.  The snapshot holds only the fragment's slices."""

    def __init__(self, engine, params, h: int, delay: int,
                 num_fragments: int):
        if not 0 <= delay < h:
            raise ValueError(f"need 0 <= delay < h, got delay={delay} h={h}")
        from repro_torch.core.streaming import fragment_masks
        self.engine = engine
        self.h, self.delay, self.F = h, delay, num_fragments
        self.masks = fragment_masks(params, num_fragments)
        self.residual = engine.init_residual(params)
        self.round = 0
        self.pending = None   # (snapshot, fragment) in flight
        self.pending_apply = -1

    def _apply_pending(self, state, step) -> Tuple[Any, Records]:
        snap, frag = self.pending
        self.pending = None
        state, self.residual = self.engine.sync(
            state, self.residual, frag=self.masks[frag], snapshot=snap,
            fragment=frag)
        return state, [("frag_syncs", (step, frag))]

    def after_step(self, state, step, loss):
        records: Records = []
        if (step + 1) % self.h == 0:
            frag = self.round % self.F
            self.pending = ([_copy_rows(w, self.masks[frag])
                             for w in state.worker_params], frag)
            self.pending_apply = step + self.delay
            self.round += 1
        if self.pending is not None and step >= self.pending_apply:
            state, recs = self._apply_pending(state, step)
            records += recs
        return state, records

    def next_event(self, step):
        cands = [(step // self.h + 1) * self.h - 1]   # next round boundary
        if self.pending is not None:
            cands.append(max(self.pending_apply, step))
        return min(cands)

    def finalize(self, state, num_steps):
        records: Records = []
        if self.pending is not None:  # flush the in-flight fragment
            state, recs = self._apply_pending(state, num_steps - 1)
            records += recs
        if num_steps % self.h:        # trailing partial round: full sync
            state, self.residual = self.engine.outer_step_ef(state,
                                                             self.residual)
            records.append(("sync_steps", num_steps - 1))
        return state, records

    def checkpoint_extras(self):
        if self.pending is not None:
            return None     # fragment in flight: defer to a clean boundary
        return {"residual": self.residual}, {"round": self.round}

    def load_extras(self, arrays, meta):
        if arrays is not None:
            self.residual = arrays["residual"]
        self.round = int(meta["round"])


@dataclasses.dataclass(frozen=True)
class PipelinedSync(SyncStrategy):
    """DiLoCoX-style pipelined low-bandwidth sync (arXiv:2506.21263): one
    fragment per outer round, overlapped with compute via ``delay``.  Each
    parameter syncs every F·H steps."""
    name = "pipelined"
    h: Optional[int] = None
    num_fragments: int = 4
    delay: int = 0

    def bind(self, engine, params) -> SyncRunner:
        return _PipelinedRunner(engine, params,
                                self.h or engine.cfg.h_inner_steps,
                                self.delay, self.num_fragments)

    def payload_schedule(self, n_params, num_steps, cfg):
        h = self.h or cfg.h_inner_steps
        codec = make_codec(cfg.delta_dtype)
        b = hop_bytes_per_worker(
            codec.schedule_bytes(n_params // self.num_fragments),
            cfg.num_workers, "gather")
        return [SyncEvent(step=s, bytes_per_worker=b, kind="fragment",
                          apply_step=s + self.delay,
                          fragment=((s + 1) // h - 1) % self.num_fragments,
                          codec=codec.name)
                for s in range(h - 1, num_steps, h)]


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

# name -> factory(cfg, h_schedule); only DiLoCo reads the H schedule, as
# in the JAX package's registry
_STRATEGY_REGISTRY: Dict[str, Any] = {
    "ddp": lambda cfg, hs: DDPSync(),
    "ddp_compressed": lambda cfg, hs: CompressedDDPSync(),
    "diloco": lambda cfg, hs: DiLoCoSync(h_schedule=hs),
    "streaming": lambda cfg, hs: StreamingSync(
        num_fragments=cfg.num_fragments),
    "overlapped": lambda cfg, hs: OverlappedSync(
        delay=cfg.sync_delay, jitter=cfg.h_jitter, seed=cfg.sync_seed),
    "pipelined": lambda cfg, hs: PipelinedSync(
        num_fragments=cfg.num_fragments, delay=cfg.sync_delay),
}
# registered in the JAX package, not ported yet
UNPORTED = ("gossip", "async_gossip")


def strategy_names() -> Tuple[str, ...]:
    """Ported strategy names, in the reference's registration order."""
    return tuple(_STRATEGY_REGISTRY)


def make_strategy(cfg: DiLoCoConfig,
                  h_schedule: Optional[HSchedule] = None) -> SyncStrategy:
    """The strategy ``cfg.strategy`` names; ``h_schedule`` reaches
    DiLoCo's runner (the other strategies ignore it, as in the JAX
    package)."""
    if cfg.strategy in UNPORTED:
        raise NotImplementedError(
            f"strategy {cfg.strategy!r} is not ported; the port has "
            f"{strategy_names()}")
    factory = _STRATEGY_REGISTRY.get(cfg.strategy)
    if factory is None:
        raise ValueError(f"unknown strategy {cfg.strategy!r}; expected one "
                         f"of {strategy_names()}")
    return factory(cfg, h_schedule)
