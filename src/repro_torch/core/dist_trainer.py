"""The distributed-training loop (the JAX package's
``core/dist_trainer.py``).

    trainer = DistTrainer(loss_fn, opt_cfg, dcfg, DiLoCoSync())
    state = trainer.init(params)
    state, hist = trainer.run(state, data_fn, num_steps)

The strategy owns when and what to synchronize (and holds the codec's
error-feedback residual); the loop runs the inner steps, records losses,
runs the eval hook, writes run checkpoints and builds the history:
``step`` / ``loss`` (every ``record_every``), ``sync_steps``,
``frag_syncs``, ``evals`` (``(step, eval_fn(global_params))`` pairs) and
``step_seconds`` (median seconds per inner step over chunks; checkpoint
and eval time kept out).

Chunks.  A chunk runs from the current step to the strategy's next event
(the next outer sync for DiLoCo), split at eval and checkpoint boundaries,
at most ``max_chunk`` steps.  Its batches are stacked on the host and
moved to the device once (``data.pipeline.stack_batches``; with
``prefetch``, assembled ahead on a background thread by ``Prefetcher``),
and the inner steps index step i of the stacked chunk.  They are enqueued
back to back; their (T, K) losses stay on the device and are read back
ONCE per chunk, then the runner's ``after_step`` is replayed per step on
the host with fixed-order means.  ``chunked=False`` runs one-step chunks
instead.  The device work is the same either way, so both give the same
losses and parameters bit for bit.

Run checkpoints.  At every ``checkpoint_every`` boundary the state, the
runner's extras (the residual) and meta (round counters) and the history
go to ``checkpoint_dir`` (``checkpoint.save_run_checkpoint``); a runner
with a snapshot in flight defers it to the next clean boundary.
``resume`` loads the latest complete checkpoint into fresh tensors and
starts at its step.

The state passed to ``run`` is updated in place (worker parameters and
optimizer states) and returned; make a fresh one with ``init`` per run.
A resume loads into fresh tensors, never into ones another run holds.

Faults.  ``faults`` (a ``core.faults.FaultSchedule``) scripts per-worker
crash / rejoin / slow / drop / corrupt events and run-level kills.  A
``FleetTracker`` follows it: every chunk starts with ``begin_chunk``
(crashes fire, their records are kept) and ends before the next crash
and at a kill (``chunk_limit``); while a worker is down the inner steps
skip it (``DiLoCoTrainer.inner_step(live=)``) and the recorded loss is
the live workers' mean; the runner (``bind_faults``, only when the
schedule has worker events, so a kill-only schedule runs the fault-free
code) runs quorum rounds.  A kill raises ``SimulatedCrash`` after its
step's due checkpoint is written; a resume fast-forwards the tracker
(``catch_up``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.checkpoint.checkpoint import (latest_run_checkpoint,
                                              load_run_checkpoint,
                                              save_run_checkpoint)
from repro_torch.configs.base import DiLoCoConfig, OptimizerConfig
from repro_torch.core.diloco import DiLoCoState
from repro_torch.core.faults import (FaultSchedule, FleetTracker,
                                     SimulatedCrash)
from repro_torch.core.streaming import StreamingDiLoCoTrainer
from repro_torch.core.sync import SyncStrategy
from repro_torch.data.pipeline import Prefetcher, stack_batches


# the default longest chunk: how many steps' losses may wait on the device
MAX_CHUNK = 128


def _fetch(t: torch.Tensor) -> np.ndarray:
    """The loop's one device->host read per chunk."""
    return t.cpu().numpy()


def _host_mean(row: np.ndarray) -> float:
    """Worker mean of a fetched (K,) f32 loss row, summed in index order,
    as the JAX package records it."""
    acc = row[0]
    for x in row[1:]:
        acc = acc + x
    return float(acc / row.dtype.type(len(row)))


def _host_mean_live(row: np.ndarray, live) -> float:
    """``_host_mean`` over the live workers' entries only (a dead worker
    was not stepped; its entry is NaN), in the same index order."""
    idx = [w for w, keep in enumerate(live) if keep]
    return _host_mean(row[idx]) if idx else float("nan")


def _history_from_json(v):
    """JSON round-trips tuples as lists; restore the tuples the history
    holds (``frag_syncs``, ``evals``)."""
    if isinstance(v, list):
        return tuple(_history_from_json(x) for x in v)
    return v


@dataclasses.dataclass(frozen=True)
class DistTrainer:
    """loss_fn(params tree, batch) -> (loss, metrics-dict); batches carry a
    leading (K, ...) worker dim (K=1 for DDP with the global batch)."""
    loss_fn: Callable
    opt_cfg: OptimizerConfig
    cfg: DiLoCoConfig
    strategy: SyncStrategy

    # The compute engine: StreamingDiLoCoTrainer is the most general
    # DiLoCoTrainer (inner step, full and fragment outer steps); strategies
    # pick which pieces they drive.
    def engine(self) -> StreamingDiLoCoTrainer:
        return StreamingDiLoCoTrainer(
            self.loss_fn, self.opt_cfg, self.cfg,
            num_fragments=getattr(self.strategy, "num_fragments", 4))

    def init(self, params) -> DiLoCoState:
        return self.engine().init(params)

    def run(self, state: DiLoCoState, data_fn, num_steps: int,
            record_every: int = 1, eval_fn: Optional[Callable] = None,
            eval_every: int = 0, *, chunked: bool = True, prefetch: int = 0,
            max_chunk: int = MAX_CHUNK,
            faults: Optional[FaultSchedule] = None, min_quorum: int = 1,
            checkpoint_dir: Optional[str] = None, checkpoint_every: int = 0,
            resume: bool = False) -> Tuple[DiLoCoState, Dict]:
        """data_fn(step) -> per-worker-stacked batch {name: (K, B, S)}
        (numpy or tensors); moved to the parameters' device here.

        ``record_every`` thins the loss history; ``eval_fn(global_params)``
        runs after every ``eval_every`` steps, after ``runner.refresh``;
        ``chunked=False`` reads the losses after every step; ``prefetch`` >
        0 assembles batches that many steps ahead on a background thread;
        ``max_chunk`` caps a chunk's length (0: only events, evals,
        checkpoints and ``num_steps`` bound it).  ``checkpoint_dir`` +
        ``checkpoint_every`` write crash-consistent checkpoints at chunk
        boundaries (deferred while a snapshot is in flight); ``resume``
        restores the latest complete one (state, runner extras, history,
        data cursor) into fresh tensors and continues bit for bit as the
        uninterrupted run would.  ``faults`` scripts failures (module
        docstring); a round proceeds with the surviving workers while at
        least ``min_quorum`` contribute and is skipped below it."""
        has_faults = faults is not None and not faults.empty
        if not chunked and prefetch > 0:
            raise ValueError(
                "prefetch requires the chunked loop (chunked=True): the "
                "per-step loop assembles batches synchronously and would "
                "silently ignore it")
        if not chunked and (has_faults or checkpoint_dir or resume):
            raise ValueError(
                "fault injection / checkpointing / resume require the "
                "chunked loop (chunked=True): the per-step loop has no "
                "chunk boundaries to anchor them to")
        if resume and not checkpoint_dir:
            raise ValueError("resume=True requires checkpoint_dir")
        eng = self.engine()
        runner = self.strategy.bind(eng, state.global_params)
        tracker = None
        if has_faults:
            faults.validate(self.cfg.num_workers)
            tracker = FleetTracker(faults, self.cfg.num_workers,
                                   min_quorum=min_quorum)
            if faults.worker_events():
                # quorum rounds; raises for runners without fault support.
                # A kill-only schedule leaves the runner unbound, so it
                # runs the fault-free code
                runner.bind_faults(tracker)
        device = state.inner_step.device
        history: Dict[str, list] = {"step": [], "loss": [], "sync_steps": [],
                                    "frag_syncs": [], "evals": []}
        start_step = 0
        if resume:
            manifest = latest_run_checkpoint(checkpoint_dir)
            if manifest is not None:
                template = runner.checkpoint_extras()
                state, extras = load_run_checkpoint(
                    manifest, state,
                    template[0] if template is not None else None)
                runner.load_extras(extras, manifest.get("extras_meta") or {})
                for key, vals in (manifest.get("history") or {}).items():
                    history[key] = [_history_from_json(v) for v in vals]
                start_step = int(manifest["step"])
                if tracker is not None:
                    tracker.catch_up(start_step)

        def record(recs):
            for key, val in recs:
                history.setdefault(key, []).append(val)

        def chunk_end(step: int) -> int:
            if not chunked:
                return step
            end = num_steps - 1
            event = runner.next_event(step)
            if event is not None:
                end = min(end, max(event, step))
            if eval_fn is not None and eval_every:
                # an eval landing mid-chunk splits the chunk: it must see
                # the state at exactly that step
                end = min(end, (step // eval_every + 1) * eval_every - 1)
            if max_chunk:
                end = min(end, step + max_chunk - 1)
            if checkpoint_dir and checkpoint_every:
                # so must a checkpoint
                end = min(end, (step // checkpoint_every + 1)
                          * checkpoint_every - 1)
            if tracker is not None:
                # end before a crash (the live set changes there) and at
                # a kill (the run dies after it)
                lim = tracker.chunk_limit(step)
                if lim is not None:
                    end = min(end, max(lim, step))
            return end

        source = (Prefetcher(data_fn, num_steps, depth=prefetch,
                             start=start_step, device=device)
                  if prefetch > 0 else None)
        chunk_step_seconds = []
        try:
            step = start_step
            t_prev = time.perf_counter()
            pending_ckpt = False
            while step < num_steps:
                live = None
                if tracker is not None:
                    live, recs = tracker.begin_chunk(step)
                    record(recs)
                    if all(live):
                        live = None     # the all-live inner steps
                end = chunk_end(step)
                T = end - step + 1
                batches = (source.take(step, T) if source is not None
                           else stack_batches([data_fn(s) for s in
                                               range(step, end + 1)],
                                              device))
                losses = []
                for i in range(T):
                    state, loss = eng.inner_step(
                        state, {k: v[i] for k, v in batches.items()},
                        live=live)
                    losses.append(loss)
                del batches
                losses_host = _fetch(torch.stack(losses))  # ONE read a chunk
                for i in range(T):
                    s = step + i
                    loss_mean = (_host_mean(losses_host[i]) if live is None
                                 else _host_mean_live(losses_host[i], live))
                    if s % record_every == 0:
                        history["step"].append(s)
                        history["loss"].append(loss_mean)
                    new_state, recs = runner.after_step(state, s, loss_mean)
                    if new_state is not state and s != end:
                        raise RuntimeError(
                            f"sync runner replaced the state at step {s}, "
                            f"mid-chunk (chunk ends at {end}): next_event() "
                            f"must report every step whose after_step "
                            f"touches device state")
                    state = new_state
                    record(recs)
                # no second reference to the state into the next chunk:
                # it would keep the K optimizer states that the next inner
                # step replaces alive beside their successors
                del new_state
                if source is not None and end + 1 < num_steps:
                    # the replay above just enqueued any outer sync: start
                    # assembling the next chunk now, so it overlaps the sync
                    source.prime(end + 1, chunk_end(end + 1) - end)
                if device.type == "cuda":
                    torch.cuda.synchronize(device)  # an outer sync is timed
                t_now = time.perf_counter()
                chunk_step_seconds.append((t_now - t_prev) / T)
                t_prev = t_now
                if checkpoint_dir and checkpoint_every and (
                        pending_ckpt or (end + 1) % checkpoint_every == 0):
                    extras = runner.checkpoint_extras()
                    if extras is None:
                        # a snapshot in flight is not saved: defer to the
                        # next clean chunk boundary
                        pending_ckpt = True
                    else:
                        pending_ckpt = False
                        arrays, extras_meta = extras
                        save_run_checkpoint(
                            checkpoint_dir, end + 1, state,
                            extras_arrays=arrays, extras_meta=extras_meta,
                            history=history, meta={"num_steps": num_steps})
                        t_prev = time.perf_counter()  # not step time
                if tracker is not None and tracker.kill_at(end):
                    # scripted process death: any due checkpoint was just
                    # written; finalize() never runs, as after a real kill
                    raise SimulatedCrash(f"scripted kill after step {end}")
                if (eval_fn is not None and eval_every
                        and (end + 1) % eval_every == 0):
                    state = runner.refresh(state)
                    history["evals"].append((end, eval_fn(
                        state.global_params)))
                    t_prev = time.perf_counter()      # not step time
                step = end + 1
        finally:
            if source is not None:
                source.close()
        state, recs = runner.finalize(state, num_steps)
        record(recs)
        history["step_seconds"] = sorted(chunk_step_seconds)[
            len(chunk_step_seconds) // 2] if chunk_step_seconds else 0.0
        return state, history
