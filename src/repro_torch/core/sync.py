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
off).

The fault layer (``core/faults.py``): a runner that understands
per-worker faults (DiLoCo, compressed DDP, streaming, pipelined, gossip)
takes a ``FleetTracker`` through ``bind_faults`` and runs each round as a
quorum round under the tracker's masks: the contributors are averaged,
the live workers adopt, rejoiners take the anchor with a fresh optimizer
state and residual (their drift is recorded first, ``rejoin_drift``), the
dead stay frozen, and a round below ``min_quorum`` is skipped (rejoiners
still adopt).  DDP, overlapped and async gossip reject per-worker events
with the reference's ``ValueError``.

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

* ``GossipSync``      — every H steps each worker averages its outer state
                          and delta with ONE peer of a deterministic
                          topology (ring / random matching / full;
                          NoLoCo, arXiv:2506.10911);
* ``AsyncGossipSync``   — gossip on per-worker step clocks (H + jitter_i)
                          against the peer's latest publication, with a
                          staleness-aware, drift-gated apply rule.

The gossip runners hold per-worker anchors and outer momentum, stacked
(K, ...) per leaf, beside the residual; ``gossip_rounds`` is their
per-pair event model for ``launch/comm_sim.simulate_gossip``.
"""
from __future__ import annotations

import dataclasses
import random as _pyrandom
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import DiLoCoConfig
from repro_torch.core import outer_opt
from repro_torch.core.drift import delta_cosine, rejoin_drift
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


def _quorum_round(tracker, state, step: int):
    """The tracker's masks for the round at ``step`` and its records, with
    ``("rejoin_drift", (step, worker, delta_norm, cos_to_live_mean))`` for
    each rejoiner, taken on the state before it adopts
    (``drift.rejoin_drift``; one host read per rejoin, never per step)."""
    info = tracker.round_masks(step)
    records = list(info.records)
    records += [("rejoin_drift", (step, w) + rejoin_drift(
        state.worker_params, state.global_params, info.live, w))
        for w, r in enumerate(info.reset) if r]
    return info, records


def _rows(mask) -> List[int]:
    return [i for i, keep in enumerate(mask) if keep]


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

    # -- fault tolerance (quorum rounds + elastic rejoin) --------------------
    # Runners that understand per-worker fault events set
    # ``supports_faults``; ``bind_faults`` hands them the
    # ``core.faults.FleetTracker`` their rounds consult (None: the
    # fault-free rounds).  Run-level ``kill`` events need no runner.
    supports_faults = False
    _tracker = None

    def bind_faults(self, tracker) -> None:
        if not self.supports_faults:
            raise ValueError(
                f"{type(self).__name__} does not support per-worker fault "
                "injection (quorum sync / elastic rejoin); use one of the "
                "fault-aware strategies (diloco / ddp_compressed / "
                "streaming / pipelined / gossip), or restrict the schedule "
                "to run-level kill/slow events")
        self._tracker = tracker

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
    supports_faults = True

    def __init__(self, engine, params, hs: HSchedule):
        self.engine = engine
        self.hs = hs
        self.since = 0
        self.residual = engine.init_residual(params)

    def _sync(self, state, step):
        if self._tracker is None:
            # no fault schedule bound: the unmasked round
            state, self.residual = self.engine.outer_step_ef(state,
                                                             self.residual)
            return state, [("sync_steps", step)]
        info, records = _quorum_round(self._tracker, state, step)
        if info.skip:
            if any(info.reset):
                state, self.residual = self.engine.adopt_anchor(
                    state, self.residual, info.reset)
            return state, records
        state, self.residual = self.engine.outer_step_quorum(
            state, self.residual, info.contrib, info.adopt, info.reset)
        records.append(("sync_steps", step))
        return state, records

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
    supports_faults = True

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
            if self._tracker is None:
                state, self.residual = self.engine.outer_step_fragment_ef(
                    state, self.masks[f], self.residual)
                return state, [("frag_syncs", (step, f))]
            info, records = _quorum_round(self._tracker, state, step)
            if info.skip:
                if any(info.reset):
                    state, self.residual = self.engine.adopt_anchor(
                        state, self.residual, info.reset)
                return state, records
            state, self.residual = self.engine.outer_step_fragment_quorum(
                state, self.masks[f], self.residual, info.contrib,
                info.adopt, info.reset)
            records.append(("frag_syncs", (step, f)))
            return state, records
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

    supports_faults = True

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
        self.pending = None   # (snapshot, fragment, RoundInfo|None) in flight
        self.pending_apply = -1

    def _apply_pending(self, state, step) -> Tuple[Any, Records]:
        snap, frag, info = self.pending
        self.pending = None
        if info is None:
            state, self.residual = self.engine.sync(
                state, self.residual, frag=self.masks[frag], snapshot=snap,
                fragment=frag)
            return state, [("frag_syncs", (step, frag))]
        if info.skip:
            if any(info.reset):
                state, self.residual = self.engine.adopt_anchor(
                    state, self.residual, info.reset)
            return state, []
        # a worker that crashed while the snapshot was in flight must not
        # adopt the landing update: intersect with the tracker's live set
        adopt_now = tuple(a and l for a, l in
                          zip(info.adopt, self._tracker.live))
        state, self.residual = self.engine.sync(
            state, self.residual, frag=self.masks[frag], snapshot=snap,
            fragment=frag, contrib=info.contrib, adopt=adopt_now,
            reset=info.reset)
        return state, [("frag_syncs", (step, frag))]

    def after_step(self, state, step, loss):
        records: Records = []
        if (step + 1) % self.h == 0:
            info = None
            if self._tracker is not None:
                # masks captured WITH the snapshot: the deltas in flight
                # are the capture-time live set's
                info, recs = _quorum_round(self._tracker, state, step)
                records += recs
            frag = self.round % self.F
            self.pending = ([_copy_rows(w, self.masks[frag])
                             for w in state.worker_params], frag, info)
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
            if self._tracker is None:
                state, self.residual = self.engine.outer_step_ef(
                    state, self.residual)
                records.append(("sync_steps", num_steps - 1))
            else:
                info = self._tracker.round_masks(num_steps - 1)
                records += list(info.records)
                if not info.skip:
                    state, self.residual = self.engine.outer_step_quorum(
                        state, self.residual, info.contrib, info.adopt,
                        info.reset)
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
# Gossip — no-all-reduce peer averaging (NoLoCo, arXiv:2506.10911)
# ---------------------------------------------------------------------------

GOSSIP_TOPOLOGIES = ("ring", "random", "full")

# columns of a leaf's stacked rows that one outer update takes at a time:
# it bounds the update's temporaries (one (K, ...) f32 stack of
# nanochat-d20's largest leaf is 2.1 GB at K 4)
GOSSIP_SLICE = 1 << 24


def _matching_from_order(order: List[int]) -> List[int]:
    """Pair consecutive entries of ``order`` into an involution: peer[i] is
    i's partner; an odd leftover is self-paired (a solo outer step)."""
    peer = list(range(len(order)))
    for a in range(0, len(order) - 1, 2):
        i, j = order[a], order[a + 1]
        peer[i], peer[j] = j, i
    return peer


def gossip_peers(k: int, round_idx: int, topology: str,
                 seed: int = 0) -> Optional[List[int]]:
    """The deterministic peer matching for one gossip round: ``peer`` with
    ``peer[peer[i]] == i``, or None for the full topology (the DiLoCo
    mean).  ``ring`` alternates the pairing offset each round; ``random``
    draws a fresh matching per round from ``(seed, round)`` through the
    same stdlib calls as the reference, so both pair the same workers."""
    if topology == "full":
        return None
    if topology == "ring":
        off = round_idx % 2
        order = [(off + j) % k for j in range(k)]
    elif topology == "random":
        order = list(range(k))
        _pyrandom.Random((seed << 32) ^ round_idx).shuffle(order)
    else:
        raise ValueError(f"unknown gossip topology {topology!r}; "
                         f"expected one of {GOSSIP_TOPOLOGIES}")
    return _matching_from_order(order)


@dataclasses.dataclass(frozen=True)
class GossipRound:
    """One gossip exchange for ``launch/comm_sim.simulate_gossip``:
    ``emit_steps[w]`` is the step at which worker w ships its ``nbytes``
    payload (-1: not this round); ``deps[w]`` the ``(src_worker,
    src_emit_step)`` transfers w's apply consumes (its peer's; all K-1 for
    the full topology; none when the contribution is dropped)."""
    emit_steps: Tuple[int, ...]
    deps: Tuple[Tuple[Tuple[int, int], ...], ...]
    nbytes: int
    codec: str = "f32"


def _gossip_payload_bytes(codec, n_params: int) -> int:
    """One gossip publication on the wire: the codec'd delta plus the
    sender's f32 anchors and outer momentum, which the pair mean reads."""
    return codec.schedule_bytes(n_params) + 2 * 4 * n_params


def _deltas(rows: Sequence[torch.Tensor],
            anchors: Sequence[torch.Tensor]) -> torch.Tensor:
    """(len(rows), ...) f32 deltas ``rows[i] - anchors[i]`` of one leaf."""
    out = torch.empty((len(rows),) + tuple(rows[0].shape),
                      dtype=torch.float32, device=rows[0].device)
    for i, (r, a) in enumerate(zip(rows, anchors)):
        torch.sub(r.float(), a.float(), out=out[i])
    return out


def _flat(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(t.shape[0], -1)


def _pair_mean(t: torch.Tensor, peer_rows: torch.Tensor) -> torch.Tensor:
    """``t * 0.5 + peer_rows * 0.5`` (``peer_rows`` is a gathered copy,
    halved in place)."""
    return (t * 0.5).add_(peer_rows.mul_(0.5))


def _gossip_outer_rows(cfg, a, v, base, v_mix, avg,
                       rows: Optional[Sequence[int]] = None) -> None:
    """Per-row Nesterov outer update of one leaf's stacked (K, ...) rows:
    ``update_leaf`` is elementwise, so on the stack it IS the per-row
    update.  Writes the new anchors and momentum into ``a`` and ``v`` (only
    the ``rows`` given, else every row), ``GOSSIP_SLICE`` columns at a
    time; ``base``, ``v_mix`` and ``avg`` were read in full before."""
    a2, v2 = _flat(a), _flat(v)
    b2, m2, d2 = _flat(base), _flat(v_mix), _flat(avg)
    for lo in range(0, a2.shape[1], GOSSIP_SLICE):
        sl = slice(lo, lo + GOSSIP_SLICE)
        new_a, new_v = outer_opt.update_leaf(b2[:, sl], m2[:, sl], d2[:, sl],
                                             cfg)
        for w in (range(len(a2)) if rows is None else rows):
            a2[w, sl].copy_(new_a[w])
            v2[w, sl].copy_(new_v[w])


def _gossip_new_state(state, k: str, a: torch.Tensor, rows: Sequence[int],
                      live: Optional[List[int]] = None) -> None:
    """Workers ``rows`` land on their updated anchors of leaf ``k``;
    ``global_params`` tracks the anchor mean (the fleet's consensus
    estimate, for evals and checkpoints) — of the ``live`` rows only
    when given (a dead worker's anchor is stale)."""
    for w in rows:
        state.worker_params[w][k].copy_(a[w])
    if live is not None:
        a = a.index_select(0, torch.tensor(live, dtype=torch.long,
                                           device=a.device))
    state.global_params[k].copy_(outer_opt._mean(a.float()))


def _adopt_consensus(state, k: str, a: torch.Tensor, v: torch.Tensor,
                     residual, vets: List[int], rst: List[int]) -> None:
    """Rejoiners ``rst`` adopt the veterans' (``vets``) anchor mean of leaf
    ``k`` with a clean slate: anchor and worker := that consensus, outer
    momentum and residual := 0 (zeros when no veteran is live, as the
    reference's masked mean gives)."""
    if vets:
        cons = outer_opt._mean(a.index_select(0, torch.tensor(
            vets, dtype=torch.long, device=a.device)).float())
    else:
        cons = torch.zeros(a.shape[1:], dtype=torch.float32, device=a.device)
    for w in rst:
        a[w].copy_(cons)
        v[w].zero_()
        if residual is not None:
            residual[k][w].zero_()
        state.worker_params[w][k].copy_(a[w])


@torch.no_grad()
def _gossip_pair(cfg, state, anchors, v, residual, peer: List[int],
                 masks=None):
    """One synchronized gossip round, leaf by leaf: encode each worker's
    delta against its own anchor, ship one peer row each (codes, then the
    peer's anchors and momentum), pair-average the whole outer state, and
    apply the per-row outer update.  Anchors, momentum, residual and
    workers are updated in place; returns the state with ``outer.t``
    advanced.

    ``GossipSync`` and ``AsyncGossipSync`` with jitter 0 and bound 0 run
    THIS function, so their equality is structural.  The pair mean is
    ``a * 0.5 + b * 0.5``: exact halves, so with equal rows (K 2) it is a
    no-op bit for bit.  Every row of a leaf is read (the gathers) before
    any row of it is written.

    ``masks`` is a quorum round's ``(active, adopt, reset)`` (the fault
    layer; ``peer`` pairs the active rows among themselves and the rest
    with themselves): only active rows take the update (anchors,
    momentum, residual, parameters); rejoiners (``reset``) then adopt the
    veterans' (``adopt``) anchor mean with zero momentum and residual
    (the caller restarts their optimizer state); ``global_params`` is the
    mean of the live rows' anchors; dead rows keep their bits."""
    transport = outer_opt.make_transport(cfg)
    act = live = None
    if masks is not None:
        active, adopt, reset = masks
        act, vets, rst = _rows(active), _rows(adopt), _rows(reset)
        live = _rows(x or y for x, y in zip(adopt, reset))
    for k, a in anchors.items():
        dq, peer_dq, new_res = transport.exchange_peers(
            {k: _deltas([w[k] for w in state.worker_params], a)}, peer,
            None if residual is None else {k: residual[k]})
        if residual is not None:
            if act is None:
                residual[k].copy_(new_res[k])
            else:
                for w in act:
                    residual[k][w].copy_(new_res[k][w])
        del new_res
        # dq * 0.5 + peer_dq * 0.5 in place: each op rounds once, as out
        # of place
        avg = dq[k].mul_(0.5).add_(peer_dq[k].mul_(0.5))
        del dq, peer_dq
        base = _pair_mean(a, transport.ship_rows(a, peer))
        v_mix = _pair_mean(v[k], transport.ship_rows(v[k], peer))
        _gossip_outer_rows(cfg, a, v[k], base, v_mix, avg, rows=act)
        del base, v_mix, avg
        if act is None:
            _gossip_new_state(state, k, a, range(len(peer)))
        else:
            _adopt_consensus(state, k, a, v[k], residual, vets, rst)
            _gossip_new_state(state, k, a, act, live)
    return state._replace(outer=state.outer._replace(t=state.outer.t + 1))


@torch.no_grad()
def _gossip_adopt(state, anchors, v, residual, reset, adopt) -> None:
    """Rejoin on a skipped gossip round: ``reset`` rows adopt the
    ``adopt`` rows' CURRENT anchor mean (no exchange, no outer update;
    the caller restarts their optimizer state); the veterans are
    untouched; ``global_params`` becomes the live rows' anchor mean."""
    vets, rst = _rows(adopt), _rows(reset)
    live = _rows(x or y for x, y in zip(adopt, reset))
    for k, a in anchors.items():
        _adopt_consensus(state, k, a, v[k], residual, vets, rst)
        _gossip_new_state(state, k, a, (), live)


@torch.no_grad()
def _gossip_async(cfg, state, anchors, v, residual, pub, pub_anch, pub_v,
                  due: List[int], peer: List[int], base_w: List[float],
                  gate: List[bool]):
    """One async-gossip apply event for the workers ``due``, in two passes
    over the leaves, since the drift gate's cosine spans the whole tree:

    1. encode each due worker's delta, publish (decoded delta, anchors,
       momentum) into the boards ``pub``, ``pub_anch``, ``pub_v`` — before
       any read, so a co-due peer is staleness 0 and reads the anchors of
       before its update — and carry the due rows' residual;
    2. weight each due worker's peer by ``base_w`` (times ``max(cos(own,
       peer), 0)`` where ``gate``), mix ``own * (1 - w) + peer * w`` for
       the delta, the anchors and the momentum, and apply the per-row
       outer update to the due rows.

    A worker that is not due advances nothing: its parameters, anchors,
    momentum, residual and publications keep their bits.  A dropped
    contribution (weight 0) reads the worker's own row, so it crosses no
    link.  Never builds a whole-model (K, P) stack."""
    transport = outer_opt.make_transport(cfg)
    codec, K = transport.codec, len(peer)
    dev = state.inner_step.device
    due_idx = torch.tensor(due, dtype=torch.long, device=dev)
    reads = list(range(K))
    for w in due:
        if base_w[w] > 0:
            reads[w] = peer[w]
    row_nbytes = {}
    for k, a in anchors.items():
        payload, new_res = codec.encode(
            {k: _deltas([state.worker_params[w][k] for w in due],
                        [a[w] for w in due])},
            None if residual is None else
            {k: residual[k].index_select(0, due_idx)})
        row_nbytes[k] = payload.nbytes() // len(due)
        dq = codec.decode(payload)[k]
        del payload
        for j, w in enumerate(due):
            pub[k][w].copy_(dq[j])
            pub_anch[k][w].copy_(a[w])
            pub_v[k][w].copy_(v[k][w])
            if residual is not None:
                residual[k][w].copy_(new_res[k][j])
        del dq, new_res
    w_eff = []
    for w in range(K):
        wt = torch.tensor(base_w[w], dtype=torch.float32, device=dev)
        if gate[w]:
            cos = delta_cosine({k: p[w] for k, p in pub.items()},
                               {k: p[peer[w]] for k, p in pub.items()})
            wt = wt * torch.clamp(cos.float(), min=0.0)
        w_eff.append(wt)
    take = torch.stack(w_eff)
    keep = 1.0 - take

    def mix(own, published, **kw):
        col = (-1,) + (1,) * (own.dim() - 1)
        return (own * keep.reshape(col)).add_(
            transport.ship_rows(published, reads, **kw)
            .mul_(take.reshape(col)))

    for k, a in anchors.items():
        avg = mix(pub[k], pub[k], codec=codec.name,
                  row_nbytes=row_nbytes[k])
        base = mix(a, pub_anch[k])
        v_mix = mix(v[k], pub_v[k])
        _gossip_outer_rows(cfg, a, v[k], base, v_mix, avg, rows=due)
        del base, v_mix, avg
        _gossip_new_state(state, k, a, due)
    return state._replace(outer=state.outer._replace(t=state.outer.t + 1))


def _stacked(params, k: int, zeros: bool = False):
    """(K, ...) per leaf: K copies of ``params`` (anchors), or f32 zeros
    (outer momentum, publications)."""
    return {n: (torch.zeros((k,) + tuple(p.shape), dtype=torch.float32,
                            device=p.device) if zeros else
                p.detach().unsqueeze(0).repeat((k,) + (1,) * p.dim()))
            for n, p in params.items()}


class _GossipRunner(SyncRunner):
    """Synchronized gossip rounds: every H steps each worker encodes its
    delta against its OWN anchor, exchanges (delta, anchors, momentum)
    with one peer of the topology schedule, and applies a per-worker
    Nesterov outer update from the pair-averaged outer state on the
    pair-averaged delta, so each pairing contracts the pair to an
    identical outer state.  The runner holds the anchors and outer
    momentum, (K, ...) per leaf, beside the residual; ``global_params``
    tracks the anchor mean at every sync.  K 2 and the full topology bind
    ``_DiLoCoRunner`` instead (``GossipSync.bind``)."""

    supports_faults = True

    def __init__(self, engine, params, h: int, topology: str, seed: int):
        if topology == "full":
            raise ValueError("full topology is the DiLoCo mean — "
                             "GossipSync.bind delegates it to _DiLoCoRunner")
        gossip_peers(2, 0, topology, seed)   # validate the topology name
        self.engine = engine
        self.h, self.topology, self.seed = h, topology, seed
        self.k = engine.cfg.num_workers
        self.since = 0
        self.round = 0
        self.anchors = _stacked(params, self.k)
        self.outer_v = _stacked(params, self.k, zeros=True)
        self.residual = engine.init_residual(params)

    def _do_sync(self, state, step):
        if self._tracker is None:
            peers = gossip_peers(self.k, self.round, self.topology,
                                 self.seed)
            records: Records = [("gossip_syncs", (step, w, peers[w], 0))
                                for w in range(self.k)]
            records.append(("sync_steps", step))
            state = _gossip_pair(self.engine.cfg, state, self.anchors,
                                 self.outer_v, self.residual, peers)
            self.round += 1
            return state, records
        info, records = _quorum_round(self._tracker, state, step)
        if info.skip:
            if any(info.reset):
                _gossip_adopt(state, self.anchors, self.outer_v,
                              self.residual, info.reset, info.adopt)
                state = self.engine.init_inner(state, info.reset)
            self.round += 1
            return state, records
        # the matching over the surviving contributors only: the
        # sub-fleet's schedule mapped back through the sorted contributor
        # indices, as the reference pairs them
        contributors = _rows(info.contrib)
        sub = gossip_peers(len(contributors), self.round, self.topology,
                           self.seed)
        peers = list(range(self.k))
        for i, w in enumerate(contributors):
            peers[w] = contributors[sub[i]]
        for w in contributors:
            records.append(("gossip_syncs", (step, w, peers[w], 0)))
        records.append(("sync_steps", step))
        state = _gossip_pair(self.engine.cfg, state, self.anchors,
                             self.outer_v, self.residual, peers,
                             masks=(info.contrib, info.adopt, info.reset))
        state = self.engine.init_inner(state, info.reset)
        self.round += 1
        return state, records

    def after_step(self, state, step, loss):
        self.since += 1
        if self.since >= self.h:
            self.since = 0
            return self._do_sync(state, step)
        return state, []

    def next_event(self, step):
        return step + max(self.h - self.since, 1) - 1

    def finalize(self, state, num_steps):
        if self.since:  # trailing partial round
            self.since = 0
            return self._do_sync(state, num_steps - 1)
        return state, []

    def checkpoint_extras(self):
        if self.since:
            return None     # mid-round: defer to the gossip boundary
        return ({"anchors": self.anchors, "outer_v": self.outer_v,
                 "residual": self.residual}, {"round": self.round})

    def load_extras(self, arrays, meta):
        if arrays is not None:
            self.anchors = arrays["anchors"]
            self.outer_v = arrays["outer_v"]
            self.residual = arrays["residual"]
        self.round = int(meta["round"])


@dataclasses.dataclass(frozen=True)
class GossipSync(SyncStrategy):
    """NoLoCo-style gossip outer sync: each round every worker averages
    anchors AND deltas with ONE peer of a deterministic ``topology``
    schedule (ring / random matching / full, keyed by ``seed``), the
    delta through the codec transport, so a worker's boundary traffic is
    one peer payload whatever the fleet size."""
    name = "gossip"
    h: Optional[int] = None
    topology: str = "ring"
    seed: int = 0

    def bind(self, engine, params) -> SyncRunner:
        h = self.h or engine.cfg.h_inner_steps
        if self.topology == "full" or engine.cfg.num_workers == 2:
            # the full matching, and K 2 (the one pair IS the fleet),
            # average all workers: the DiLoCo mean, so the DiLoCo runner
            # itself runs it and the equality is structural
            return _DiLoCoRunner(engine, params, FixedH(h))
        return _GossipRunner(engine, params, h, self.topology, self.seed)

    def payload_schedule(self, n_params, num_steps, cfg):
        h = self.h or cfg.h_inner_steps
        codec = make_codec(cfg.delta_dtype)
        if self.topology == "full":
            # the DiLoCo mean: anchors are common, only the deltas travel
            b = hop_bytes_per_worker(codec.schedule_bytes(n_params),
                                     cfg.num_workers, "gather")
        else:
            b = hop_bytes_per_worker(_gossip_payload_bytes(codec, n_params),
                                     cfg.num_workers, "peer")
        return [SyncEvent(step=s, bytes_per_worker=b, kind="delta",
                          apply_step=s, codec=codec.name)
                for s in range(h - 1, num_steps, h)]

    def gossip_rounds(self, n_params, num_steps, cfg) -> List[GossipRound]:
        """Per-pair event model for ``comm_sim.simulate_gossip``."""
        h = self.h or cfg.h_inner_steps
        k = cfg.num_workers
        codec = make_codec(cfg.delta_dtype)
        b = (codec.schedule_bytes(n_params) if self.topology == "full"
             else _gossip_payload_bytes(codec, n_params))
        rounds = []
        for r, s in enumerate(range(h - 1, num_steps, h)):
            peers = gossip_peers(k, r, self.topology, self.seed)
            if peers is None:
                deps = tuple(tuple((j, s) for j in range(k) if j != w)
                             for w in range(k))
            else:
                deps = tuple(((peers[w], s),) if peers[w] != w else ()
                             for w in range(k))
            rounds.append(GossipRound(emit_steps=(s,) * k, deps=deps,
                                      nbytes=b, codec=codec.name))
        return rounds


class _AsyncGossipRunner(SyncRunner):
    """Gossip on per-worker step clocks: worker i syncs every
    ``periods[i] = H + jitter_i`` steps against the latest (delta,
    anchors, momentum) its peer PUBLISHED, with no barrier.  The peer's
    weight follows its staleness s = own step - peer's publish step:

    * s == 0           — co-due peer: the plain 0.5 / 0.5 pair average;
    * 0 < s <= bound   — 0.5 · (1 - s / (bound + 1)), times the observed
                         drift ``max(cos(own delta, peer delta), 0)``
                         (``core/drift.delta_cosine``);
    * s > bound / none — dropped: a solo outer step on the own delta.

    With jitter 0 and bound 0 every worker is co-due every H at
    staleness 0, and the apply runs ``_gossip_pair``, the function
    ``_GossipRunner`` runs: the reduction to the synchronous barrier is
    bit for bit by construction."""

    def __init__(self, engine, params, h: int, topology: str,
                 staleness_bound: int, jitter: int, seed: int):
        if topology == "full":
            raise ValueError(
                "async gossip is peer-based; topology='full' is the "
                "synchronous DiLoCo mean — use GossipSync(topology='full') "
                "or DiLoCoSync")
        gossip_peers(2, 0, topology, seed)   # validate the topology name
        if jitter < 0 or staleness_bound < 0:
            raise ValueError(
                f"jitter and staleness_bound must be >= 0, got "
                f"jitter={jitter} staleness_bound={staleness_bound}")
        self.engine = engine
        self.k = k = engine.cfg.num_workers
        self.h, self.topology = h, topology
        self.bound = staleness_bound
        self.seed = seed
        rng = _pyrandom.Random(seed)
        self.periods = tuple(
            h + (rng.randint(0, jitter) if jitter else 0) for _ in range(k))
        self.fully_sync = (jitter == 0 and staleness_bound == 0)
        self.anchors = _stacked(params, k)
        self.outer_v = _stacked(params, k, zeros=True)
        self.residual = engine.init_residual(params)
        self.pub_step = [-(10 ** 9)] * k      # host-side publish clocks
        self.rounds = [0] * k
        if self.fully_sync:
            self.pub = self.pub_anch = self.pub_v = None
        else:
            # published (decoded delta, anchors, momentum), on the device
            self.pub = _stacked(params, k, zeros=True)
            self.pub_anch = {n: torch.zeros_like(a)
                             for n, a in self.anchors.items()}
            self.pub_v = _stacked(params, k, zeros=True)

    def _do_apply(self, state, step, due):
        k = self.k
        peer = list(range(k))
        base_w = [0.0] * k
        gate = [False] * k
        records: Records = []
        for w in due:                     # publish BEFORE any read, so a
            self.pub_step[w] = step       # co-due peer is staleness 0
        for w in due:
            p = gossip_peers(k, self.rounds[w], self.topology, self.seed)[w]
            peer[w] = p
            s = step - self.pub_step[p] if self.pub_step[p] >= 0 else -1
            if p == w or s < 0 or s > self.bound:
                base_w[w] = 0.0           # drop: solo outer step
            elif s == 0:
                base_w[w] = 0.5
            else:
                base_w[w] = 0.5 * (1.0 - s / (self.bound + 1.0))
                gate[w] = True            # stale: drift-reweighted
            records.append(("gossip_syncs", (step, w, p, s)))
            self.rounds[w] += 1
        if len(due) == k:
            records.append(("sync_steps", step))
        if self.fully_sync:
            # equal clocks + bound 0: the whole fleet is due and every
            # peer co-due — the synchronous pair function
            state = _gossip_pair(self.engine.cfg, state, self.anchors,
                                 self.outer_v, self.residual, peer)
            return state, records
        state = _gossip_async(self.engine.cfg, state, self.anchors,
                              self.outer_v, self.residual, self.pub,
                              self.pub_anch, self.pub_v, due, peer, base_w,
                              gate)
        return state, records

    def after_step(self, state, step, loss):
        due = [w for w in range(self.k)
               if (step + 1) % self.periods[w] == 0]
        if not due:
            return state, []
        return self._do_apply(state, step, due)

    def next_event(self, step):
        return min((step // p + 1) * p - 1 for p in self.periods)

    def finalize(self, state, num_steps):
        due = [w for w in range(self.k) if num_steps % self.periods[w] != 0]
        if not due:
            return state, []
        return self._do_apply(state, num_steps - 1, due)

    def checkpoint_extras(self):
        # the boards and clocks hold everything in flight, so every chunk
        # boundary is clean
        arrays = {"anchors": self.anchors, "outer_v": self.outer_v,
                  "residual": self.residual}
        if not self.fully_sync:
            arrays.update(pub=self.pub, pub_anch=self.pub_anch,
                          pub_v=self.pub_v)
        return arrays, {"pub_step": list(self.pub_step),
                        "rounds": list(self.rounds)}

    def load_extras(self, arrays, meta):
        if arrays is not None:
            self.anchors = arrays["anchors"]
            self.outer_v = arrays["outer_v"]
            self.residual = arrays["residual"]
            if not self.fully_sync:
                self.pub = arrays["pub"]
                self.pub_anch = arrays["pub_anch"]
                self.pub_v = arrays["pub_v"]
        self.pub_step = [int(x) for x in meta["pub_step"]]
        self.rounds = [int(x) for x in meta["rounds"]]


@dataclasses.dataclass(frozen=True)
class AsyncGossipSync(SyncStrategy):
    """Gossip on per-worker step clocks with a staleness-aware apply rule:
    worker i syncs every ``H + jitter_i`` steps (jitter drawn from
    ``seed``), consumes its peer's latest PUBLISHED delta without a
    barrier, and drops or drift-reweights contributions staler than
    ``staleness_bound`` inner steps.  ``jitter=0, staleness_bound=0`` is
    ``GossipSync`` bit for bit (the synchronous barrier)."""
    name = "async_gossip"
    h: Optional[int] = None
    topology: str = "ring"
    staleness_bound: int = 0
    jitter: int = 0
    seed: int = 0

    def bind(self, engine, params) -> SyncRunner:
        h = self.h or engine.cfg.h_inner_steps
        if (self.jitter == 0 and self.staleness_bound == 0
                and engine.cfg.num_workers == 2
                and self.topology != "full"):
            # equal clocks + bound 0 + one pair: the synchronous fleet
            # mean, delegated as GossipSync does at K 2 (full still falls
            # through to the runner's rejection)
            gossip_peers(2, 0, self.topology, self.seed)  # validate name
            return _DiLoCoRunner(engine, params, FixedH(h))
        return _AsyncGossipRunner(engine, params, h, self.topology,
                                  self.staleness_bound, self.jitter,
                                  self.seed)

    def _periods(self, h: int, k: int) -> Tuple[int, ...]:
        rng = _pyrandom.Random(self.seed)
        return tuple(
            h + (rng.randint(0, self.jitter) if self.jitter else 0)
            for _ in range(k))

    def payload_schedule(self, n_params, num_steps, cfg):
        # the mean worker's footprint: one peer payload every ~H steps,
        # with the staleness window as overlap budget; the per-worker
        # event model is gossip_rounds + comm_sim.simulate_gossip
        h = self.h or cfg.h_inner_steps
        codec = make_codec(cfg.delta_dtype)
        b = hop_bytes_per_worker(_gossip_payload_bytes(codec, n_params),
                                 cfg.num_workers, "peer")
        return [SyncEvent(step=s, bytes_per_worker=b, kind="delta",
                          apply_step=s + self.staleness_bound,
                          codec=codec.name)
                for s in range(h - 1, num_steps, h)]

    def gossip_rounds(self, n_params, num_steps, cfg) -> List[GossipRound]:
        """Replay the runner's publish / consume schedule as simulator
        events: one ``GossipRound`` per step with due workers, pair deps
        only for consumed (not dropped) contributions."""
        h = self.h or cfg.h_inner_steps
        k = cfg.num_workers
        codec = make_codec(cfg.delta_dtype)
        b = _gossip_payload_bytes(codec, n_params)
        periods = self._periods(h, k)
        pub = [-(10 ** 9)] * k
        rounds_count = [0] * k
        out = []
        for step in range(num_steps):
            due = [w for w in range(k) if (step + 1) % periods[w] == 0]
            if not due:
                continue
            for w in due:
                pub[w] = step
            emit = [-1] * k
            deps: List[Tuple] = [()] * k
            for w in due:
                emit[w] = step
                p = gossip_peers(k, rounds_count[w], self.topology,
                                 self.seed)[w]
                s = step - pub[p]
                if p != w and s <= self.staleness_bound:
                    deps[w] = ((p, pub[p]),)
                rounds_count[w] += 1
            out.append(GossipRound(emit_steps=tuple(emit), deps=tuple(deps),
                                   nbytes=b, codec=codec.name))
        return out


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
    "gossip": lambda cfg, hs: GossipSync(topology=cfg.topology,
                                         seed=cfg.sync_seed),
    "async_gossip": lambda cfg, hs: AsyncGossipSync(
        topology=cfg.topology, staleness_bound=cfg.staleness_bound,
        jitter=cfg.h_jitter, seed=cfg.sync_seed),
}


def strategy_names() -> Tuple[str, ...]:
    """Strategy names, in the reference's registration order."""
    return tuple(_STRATEGY_REGISTRY)


def make_strategy(cfg: DiLoCoConfig,
                  h_schedule: Optional[HSchedule] = None) -> SyncStrategy:
    """The strategy ``cfg.strategy`` names; ``h_schedule`` reaches
    DiLoCo's runner (the other strategies ignore it, as in the JAX
    package)."""
    factory = _STRATEGY_REGISTRY.get(cfg.strategy)
    if factory is None:
        raise ValueError(f"unknown strategy {cfg.strategy!r}; expected one "
                         f"of {strategy_names()}")
    return factory(cfg, h_schedule)
