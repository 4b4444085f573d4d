"""Deterministic fault injection for the elastic training runtime (a copy
of the JAX package's ``core/faults.py``: stdlib only, the same code, its
docstrings cut to the port's terms).

The paper's setting — communication-constrained, decentralized fleets — is
exactly where workers are preemptible and links flake, yet a scripted
failure is the only kind a CI box can *reproduce*.  This module makes
failure a first-class, bit-exactly replayable event:

* ``FaultSchedule`` — an immutable script of per-worker events
  (crash-at-step, rejoin-at-step, slowdown factor, dropped/corrupted
  outer payload) plus run-level ``kill`` events (the whole process dies,
  the crash-consistency anchor for ``--resume``).  Schedules load from
  JSON files or a compact inline spec
  (``"crash:2@10,rejoin:2@20,slow:1@5x1.5,drop:3@9x2,kill@30"``) and can
  be drawn from a seeded RNG (``FaultSchedule.random``) — either way the
  event list is data, so any box replays the same failures.
* ``FleetTracker`` — the host-side state machine ``DistTrainer.run`` and
  the sync runners consult: per-worker liveness, pending rejoins, the
  per-round contribution/adoption/reset masks (length-K tuples of
  bools, which pick the rows the quorum outer steps average, adopt or
  reset), the ``min_quorum`` skip rule, and the one-retry accounting for
  dropped payloads.
* ``SimulatedCrash`` — raised by the trainer after a ``kill`` event's
  step completes (and after any due checkpoint is written), so the
  crash/resume tests exercise the same code path a real SIGKILL would
  leave behind.

Semantics (all step indices are inner-step indices):

* ``crash w@s``  — worker w executes steps ``< s`` only; from step s its
  row is frozen (masked out of inner chunks) and it neither contributes
  to nor adopts outer rounds.
* ``rejoin w@s`` — at the first outer boundary ``>= s`` the worker
  re-enters by adopting the current anchor with zeroed inner-optimizer
  and error-feedback state; ``core.drift`` metrics are logged at the
  adoption so the drift cost of churn is measurable.
* ``slow w@s xF`` — from step s, worker w's modeled step time is
  multiplied by F.  Training math is unchanged (the simulation is
  synchronous); the comm simulator consumes it for wall-clock.
* ``drop/corrupt w@s [xN]`` — worker w's outer payload at the sync
  boundary at step s fails N times (default 1).  One codec-aware retry
  is attempted; with N >= 2 the retry also fails and the worker is
  counted out of THAT round's average (it still adopts the result — its
  downlink is fine).
* ``kill@s``     — the whole run raises ``SimulatedCrash`` after step s.
"""
from __future__ import annotations

import dataclasses
import json
import os
import random as _pyrandom
from typing import Dict, List, Optional, Sequence, Tuple

FAULT_KINDS = ("crash", "rejoin", "slow", "drop", "corrupt", "kill")

# events a runner resolves at an outer boundary (vs. trainer chunk gating)
_PAYLOAD_KINDS = ("drop", "corrupt")


class SimulatedCrash(RuntimeError):
    """Raised by ``DistTrainer.run`` when a scripted ``kill`` event fires —
    after the step's bookkeeping (and any due checkpoint) completes, so a
    catcher observes exactly what a process kill would leave on disk."""


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scripted failure.  ``worker`` is -1 for run-level ``kill``;
    ``factor`` is the slowdown multiplier for ``slow``; ``attempts`` is
    how many consecutive sends fail for ``drop``/``corrupt`` (1 = the
    retry succeeds, >= 2 = counted out of the round)."""
    step: int
    kind: str
    worker: int = -1
    factor: float = 1.0
    attempts: int = 1

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"expected one of {FAULT_KINDS}")
        if self.step < 0:
            raise ValueError(f"fault step must be >= 0, got {self.step}")
        if self.kind != "kill" and self.worker < 0:
            raise ValueError(f"{self.kind} event needs a worker index")
        if self.kind == "slow" and self.factor <= 0:
            raise ValueError(f"slow factor must be > 0, got {self.factor}")
        if self.attempts < 1:
            raise ValueError(f"attempts must be >= 1, got {self.attempts}")


@dataclasses.dataclass(frozen=True)
class FaultSchedule:
    """An immutable, order-independent script of ``FaultEvent``s."""
    events: Tuple[FaultEvent, ...] = ()

    # -- construction --------------------------------------------------------
    @classmethod
    def from_spec(cls, spec: str) -> "FaultSchedule":
        """Parse the compact inline DSL: comma-separated
        ``kind:worker@step[xFACTOR]`` items (``kill@step`` has no worker).
        Examples: ``crash:2@10``, ``rejoin:2@20``, ``slow:1@5x1.5``,
        ``drop:3@9x2`` (two failed attempts — counted out), ``kill@30``.
        A path ending in ``.json`` loads the JSON file instead."""
        spec = spec.strip()
        if not spec:
            return cls()
        if spec.endswith(".json") or os.path.sep in spec:
            return cls.load(spec)
        events = []
        for item in spec.split(","):
            item = item.strip()
            if not item:
                continue
            kind, _, rest = item.partition(":")
            kind = kind.strip()
            if kind.partition("@")[0] == "kill":
                # kill@step (no worker); kill:@step also tolerated
                at = (rest or kind).partition("@")[2]
                events.append(FaultEvent(step=int(at), kind="kill"))
                continue
            wtxt, _, at = rest.partition("@")
            extra = 1.0
            if "x" in at:
                at, _, xtxt = at.partition("x")
                extra = float(xtxt)
            ev = dict(step=int(at), kind=kind, worker=int(wtxt))
            if kind == "slow":
                ev["factor"] = extra
            elif kind in _PAYLOAD_KINDS:
                ev["attempts"] = max(int(extra), 1)
            events.append(FaultEvent(**ev))
        return cls(tuple(events))

    @classmethod
    def load(cls, path: str) -> "FaultSchedule":
        with open(path) as f:
            data = json.load(f)
        if isinstance(data, dict):
            data = data.get("events", [])
        return cls(tuple(FaultEvent(**e) for e in data))

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({"events": [dataclasses.asdict(e)
                                  for e in self.events]}, f, indent=1)

    @classmethod
    def random(cls, k: int, num_steps: int, seed: int,
               crashes: int = 1, rejoin_after: Optional[int] = None
               ) -> "FaultSchedule":
        """A seeded crash/rejoin scenario: ``crashes`` distinct workers
        crash at seeded steps; the first crashed worker rejoins
        ``rejoin_after`` steps later (None = never).  Pure function of
        the arguments — the draw IS the script, so it replays anywhere."""
        rng = _pyrandom.Random(seed)
        workers = rng.sample(range(k), min(crashes, k))
        events = []
        for i, w in enumerate(workers):
            s = rng.randrange(1, max(num_steps - 1, 2))
            events.append(FaultEvent(step=s, kind="crash", worker=w))
            if i == 0 and rejoin_after is not None:
                events.append(FaultEvent(
                    step=min(s + rejoin_after, num_steps - 1),
                    kind="rejoin", worker=w))
        return cls(tuple(sorted(events, key=lambda e: e.step)))

    # -- queries -------------------------------------------------------------
    @property
    def empty(self) -> bool:
        return not self.events

    def worker_events(self) -> Tuple[FaultEvent, ...]:
        return tuple(e for e in self.events if e.kind != "kill")

    def validate(self, k: int) -> None:
        for e in self.events:
            if e.kind != "kill" and not 0 <= e.worker < k:
                raise ValueError(
                    f"fault event {e} names worker {e.worker} outside the "
                    f"fleet (num_workers={k})")

    def chunk_limit(self, step: int) -> Optional[int]:
        """Last step a chunk starting at ``step`` may include: a chunk
        must end BEFORE a crash (the mask changes at the crash step) and
        AT a kill (the process dies after it)."""
        lim = None

        def take(x):
            nonlocal lim
            lim = x if lim is None else min(lim, x)

        for e in self.events:
            if e.kind == "crash" and e.step > step:
                take(e.step - 1)
            elif e.kind == "kill" and e.step >= step:
                take(e.step)
        return lim


@dataclasses.dataclass
class RoundInfo:
    """Masks for one quorum outer round (all length-K bool tuples).

    ``contrib`` — rows averaged this round (live, payload survived);
    ``adopt``   — rows that take the round's result (live workers incl.
                  dropped-payload ones — their downlink works);
    ``reset``   — rejoiners: adopt AND restart inner/EF state from zero;
    ``live``    — alive after this round (adopt ∪ reset);
    ``skip``    — quorum not met: no averaging, rejoiners still adopt;
    ``retries`` — payload resends attempted this round (byte accounting);
    ``records`` — history records describing the round's fault activity.
    """
    contrib: Tuple[bool, ...]
    adopt: Tuple[bool, ...]
    reset: Tuple[bool, ...]
    live: Tuple[bool, ...]
    skip: bool
    retries: int
    records: List


class FleetTracker:
    """Host-side fleet state: consumes a ``FaultSchedule`` as the trainer
    advances.  All decisions are pure functions of (schedule, k,
    min_quorum, step) — the tracker only caches them — so replays are
    bit-exact by construction."""

    def __init__(self, schedule: FaultSchedule, k: int, min_quorum: int = 1):
        schedule.validate(k)
        if not 1 <= min_quorum <= k:
            raise ValueError(f"min_quorum must be in [1, {k}], "
                             f"got {min_quorum}")
        self.schedule = schedule
        self.k = k
        self.min_quorum = min_quorum
        self.live: List[bool] = [True] * k
        # worker -> rejoin step, applied at the next outer boundary >= it
        self.pending_rejoin: Dict[int, int] = {}
        self._crash_done: set = set()
        self._rejoin_done: set = set()
        self.quorum_log: List[Tuple[int, int]] = []  # (step, contributors)

    # -- trainer-facing ------------------------------------------------------
    def chunk_limit(self, step: int) -> Optional[int]:
        return self.schedule.chunk_limit(step)

    def kill_at(self, step: int) -> bool:
        return any(e.kind == "kill" and e.step == step
                   for e in self.schedule.events)

    def begin_chunk(self, step: int) -> Tuple[Tuple[bool, ...], List]:
        """Apply crash (and queue rejoin/slow) events with
        ``event.step <= step``; returns (live mask for the chunk,
        history records for newly-fired events)."""
        records: List = []
        for i, e in enumerate(self.schedule.events):
            if e.step > step or i in self._crash_done:
                continue
            if e.kind == "crash":
                self._crash_done.add(i)
                if self.live[e.worker]:
                    self.live[e.worker] = False
                    self.pending_rejoin.pop(e.worker, None)
                    records.append(("fault", (e.step, "crash", e.worker)))
            elif e.kind == "rejoin":
                self._crash_done.add(i)
                if not self.live[e.worker] and e.worker not in self.pending_rejoin:
                    self.pending_rejoin[e.worker] = e.step
                    records.append(("fault", (e.step, "rejoin_pending",
                                              e.worker)))
            elif e.kind == "slow":
                self._crash_done.add(i)
                records.append(("fault", (e.step, "slow", e.worker,
                                          e.factor)))
        return tuple(self.live), records

    def catch_up(self, step: int) -> None:
        """Fast-forward fleet state to a resume point: crashes strictly
        before ``step`` have happened, and rejoins strictly before
        ``step`` are treated as already adopted (resume checkpoints are
        written at outer boundaries, after pending rejoins land)."""
        if step <= 0:
            return
        self.begin_chunk(step - 1)
        for w, s in list(self.pending_rejoin.items()):
            if s < step:
                self.live[w] = True
                del self.pending_rejoin[w]

    @property
    def all_live(self) -> bool:
        return all(self.live) and not self.pending_rejoin

    # -- runner-facing -------------------------------------------------------
    def round_masks(self, step: int) -> RoundInfo:
        """Masks for the outer round at boundary ``step``.  Mutates the
        tracker (rejoiners become live) — call exactly once per boundary,
        which the chunked loop guarantees (a boundary is a chunk end and
        ``after_step`` replays each step once)."""
        records: List = []
        k = self.k
        # queue rejoins due by this boundary straight from the schedule:
        # a rejoin step landing MID-chunk never starts a chunk of its own
        # (chunks split at crashes and kills only), so ``begin_chunk``
        # alone would miss it until the next chunk — too late for the
        # boundary that should apply it
        for i, e in enumerate(self.schedule.events):
            if e.kind != "rejoin" or e.step > step \
                    or i in self._crash_done:
                continue
            self._crash_done.add(i)
            if not self.live[e.worker] \
                    and e.worker not in self.pending_rejoin:
                self.pending_rejoin[e.worker] = e.step
                records.append(("fault", (e.step, "rejoin_pending",
                                          e.worker)))
        contrib = list(self.live)
        retries = 0
        for e in self.schedule.events:
            if e.step != step or e.kind not in _PAYLOAD_KINDS:
                continue
            if not self.live[e.worker]:
                continue        # a dead worker ships nothing to drop
            retries += 1        # the one codec-aware retry is attempted
            if e.attempts >= 2:
                contrib[e.worker] = False   # retry failed too: counted out
                records.append(("fault", (step, e.kind + "_lost", e.worker)))
            else:
                records.append(("fault", (step, e.kind + "_retry", e.worker)))
        reset = [False] * k
        for w, s in sorted(self.pending_rejoin.items()):
            if s <= step:
                reset[w] = True
                self.live[w] = True
                del self.pending_rejoin[w]
                records.append(("fault", (step, "rejoin", w)))
        adopt = list(self.live)
        for w in range(k):
            if reset[w]:
                adopt[w] = False   # rejoiners adopt via the reset path
        n_contrib = sum(contrib)
        skip = n_contrib < self.min_quorum
        self.quorum_log.append((step, n_contrib))
        records.append(("quorum", (step, n_contrib)))
        if skip:
            records.append(("quorum_skip", step))
        return RoundInfo(contrib=tuple(contrib), adopt=tuple(adopt),
                         reset=tuple(reset), live=tuple(self.live),
                         skip=skip, retries=retries, records=records)


# ---------------------------------------------------------------------------
# Comm-simulator view: per-worker wall-clock effects of the same script
# ---------------------------------------------------------------------------

def sim_timeline(schedule: FaultSchedule, k: int, num_steps: int
                 ) -> Tuple[List[List[bool]], List[List[float]],
                            Dict[int, List[int]]]:
    """Expand the schedule into per-step per-worker (alive, speed-factor)
    tables plus ``failed_sends[step] -> [workers whose payload is lost
    even after the retry]`` — the form the wall-clock simulators consume.
    Pure function of the script; the training-side ``FleetTracker`` and
    this expansion agree on liveness by construction (same event rules).
    """
    schedule.validate(k)
    alive = [True] * k
    factor = [1.0] * k
    alive_t: List[List[bool]] = []
    factor_t: List[List[float]] = []
    failed: Dict[int, List[int]] = {}
    by_step: Dict[int, List[FaultEvent]] = {}
    for e in schedule.events:
        by_step.setdefault(e.step, []).append(e)
    for s in range(num_steps):
        for e in by_step.get(s, ()):
            if e.kind == "crash":
                alive[e.worker] = False
            elif e.kind == "rejoin":
                alive[e.worker] = True
            elif e.kind == "slow":
                factor[e.worker] = e.factor
            elif e.kind in _PAYLOAD_KINDS and e.attempts >= 2:
                failed.setdefault(s, []).append(e.worker)
        alive_t.append(list(alive))
        factor_t.append(list(factor))
    return alive_t, factor_t, failed


def retry_counts(schedule: FaultSchedule, num_steps: int) -> Dict[int, int]:
    """step -> number of payload retries shipped at that step (every
    drop/corrupt event triggers exactly one resend attempt)."""
    out: Dict[int, int] = {}
    for e in schedule.events:
        if e.kind in _PAYLOAD_KINDS and e.step < num_steps:
            out[e.step] = out.get(e.step, 0) + 1
    return out
