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

A process mesh.  With ``replicate_fn=mesh.replicate_fn``
(``launch/mesh.py``) this process is one rank of a (pod, data) grid of
``torch.distributed`` ranks: DiLoCo's K workers are the K pods, one
worker a rank, and DDP runs on the data axis of one pod.  Every strategy,
H schedule, fault schedule and run checkpoint runs so, and reaches the
one-process loop's state bit for bit.  ``run`` cuts each ``data_fn(step)``
to this rank's part (its pod's worker row, its data index's share of the
rows) before the batch reaches the device, the inner steps issue no
collective across pods, and the rounds move the encoded payload across
them (an all-gather; a quorum round broadcasts its contributors' rows
only; gossip sends point to point).  The history's ``loss`` is this
rank's worker's, and it gains ``inner_seconds`` (each chunk's seconds per
inner step) and ``sync_seconds`` (each chunk that synced: the seconds of
its rounds, the device synchronized).  When the runner reads the loss
(an H schedule such as ``AdaptiveH``) or a checkpoint records it, each
chunk's loss row is all-gathered across pods after the chunk's one read,
the runner gets the fleet's mean (summed in worker order, as in one
process, so every rank decides the same rounds) and the history gains
``fleet_loss``, the one-process ``loss``.  The mesh's collective log tags
what the inner steps issue ``inner``, the rounds ``outer``, the loss row
``loss`` and a checkpoint's gather ``checkpoint`` (the runners add
``quorum`` and ``consensus``; ``launch.collectives.scope``).

Run checkpoints across ranks are written in the one-process layout, so a
checkpoint does not depend on the world size: rank 0 gathers every
worker's rows (parameters, inner optimizer state, the runner's per-worker
arrays) leaf by leaf through the host and writes the arrays, the ranks
meet at a barrier, and rank 0 writes the manifest (its history the
one-process one, each recorded step's worker losses in its ``meta``).  A
resume loads that layout on every rank and keeps the rank's own rows, so
a checkpoint crosses between one process and any number of ranks.

Tensor parallelism.  On a mesh whose ``model`` axis splits each worker
(``replicate_fn.tp``) the run holds DiLoCo (``diloco``, fixed H) and
DDP (``ddp``) on every wire, with run checkpoints: the whole run goes
under the model axis (``models.tensor_parallel.use``), ``init`` shards,
and a checkpoint gathers each leaf over the model group to model index
0, whose ranks alone then run the pod gather (so it keeps the
one-process layout and resumes at any model size: a resume cuts what
it loads to the rank's shards).  Every model rank of a worker computes
the same loss, bit for bit.  Drift-aware averaging sums its cosines
over the shards.  The other strategies, an H schedule (AdaptiveH) and
the fault layer are refused by name (ROADMAP §1).

ZeRO-3 over the data axis.  On a mesh with ``fsdp``
(``replicate_fn.sharded``, ``models/fsdp.py``) the same holds with the
data ranks splitting each worker as well: DiLoCo (fixed H, drift-aware
or not) and DDP, every wire, run checkpoints (each leaf joined over the
model group, then over the data group among the model-index-0 ranks,
before the pod gather: the file is the one-process layout, and a resume
cuts it on both axes); the same strategies and options are refused.

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

import contextlib
import dataclasses
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.checkpoint.checkpoint import (_children, _leaves,
                                              latest_run_checkpoint,
                                              load_run_checkpoint,
                                              save_run_checkpoint)
from repro_torch.configs.base import DiLoCoConfig, OptimizerConfig
from repro_torch.core.diloco import DiLoCoState, under_model_axis
from repro_torch.core.faults import (FaultSchedule, FleetTracker,
                                     SimulatedCrash)
from repro_torch.core.streaming import StreamingDiLoCoTrainer
from repro_torch.core.sync import SyncStrategy
from repro_torch.core.transport import ranked
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


# history keys of a rank of a process mesh only (not in a checkpoint)
_RANK_KEYS = ("inner_seconds", "sync_seconds", "fleet_loss")
# the strategies a model axis > 1 or fsdp runs (ROADMAP §1 has the rest)
TP_STRATEGIES = ("diloco", "ddp")


def _rebuild(tree, leaf_fn, prefix: str = ""):
    """``tree``'s structure with each leaf replaced by ``leaf_fn(path,
    leaf)`` (the paths of ``checkpoint._leaves``)."""
    if tree is None:
        return None
    kids = _children(tree)
    if kids is None:
        return leaf_fn(prefix, tree)
    vals = {k: _rebuild(v, leaf_fn, f"{prefix}/{k}" if prefix else k)
            for k, v in kids}
    if isinstance(tree, dict):
        return {k: vals[str(k)] for k in tree}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(**vals)
    return type(tree)(vals[str(i)] for i in range(len(tree)))


def _gathered(tree, rep, rows_of):
    """Every worker's rows of ``tree`` on rank 0, leaf by leaf through the
    host (``rep.gather_to_lead``; scope ``checkpoint``): ``rows_of(leaf)``
    is a tensor leaf's (1, ...) row; returns the K host rows of each
    tensor leaf by path (None on the other ranks)."""
    out = {}
    with rep.scope("checkpoint"):
        for path, leaf in _leaves(tree):
            if isinstance(leaf, torch.Tensor):
                out[path] = rep.gather_to_lead(rows_of(leaf))
    return out if rep.lead else None


def _one_process_state(state, rep):
    """The one-process layout of a rank's state on rank 0: every worker's
    parameters and inner optimizer state (None on the other ranks)."""
    per = [(name, _gathered(getattr(state, name)[0], rep,
                            lambda t: t.unsqueeze(0)))
           for name in ("worker_params", "inner_opt")]
    if not rep.lead:
        return None
    k = rep.num_rows
    return state._replace(**{
        name: [_rebuild(getattr(state, name)[0],
                        lambda p, leaf, w=w, g=g: g[p][w][0] if p in g
                        else leaf) for w in range(k)]
        for name, g in per})


def _one_process_extras(arrays, rep):
    """A runner's per-worker arrays, each leaf's (1, ...) row, as the
    one-process (K, ...) stacks on rank 0 (None on the other ranks)."""
    g = _gathered(arrays, rep, lambda t: t)
    if not rep.lead:
        return None
    return _rebuild(arrays, lambda p, leaf: torch.cat(g[p])
                    if p in g else leaf)


def _n_syncs(history) -> int:
    """Rounds recorded so far, of every strategy's kind."""
    return sum(len(history.get(k, ())) for k in
               ("sync_steps", "frag_syncs", "gossip_syncs"))


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
    replicate_fn: Optional[Callable] = None

    # The compute engine: StreamingDiLoCoTrainer is the most general
    # DiLoCoTrainer (inner step, full and fragment outer steps); strategies
    # pick which pieces they drive.
    def engine(self) -> StreamingDiLoCoTrainer:
        return StreamingDiLoCoTrainer(
            self.loss_fn, self.opt_cfg, self.cfg, self.replicate_fn,
            num_fragments=getattr(self.strategy, "num_fragments", 4))

    def _check_processes(self) -> None:
        """A process mesh holds one worker row a pod: its pods must be the
        config's workers."""
        rows = getattr(self.replicate_fn, "num_rows", self.cfg.num_workers)
        if rows != self.cfg.num_workers:
            raise ValueError(f"the mesh holds {rows} worker rows (pods) but "
                             f"the config has {self.cfg.num_workers} "
                             f"workers")

    def init(self, params) -> DiLoCoState:
        return self.engine().init(params)

    def _check_model_axis(self, faults) -> None:
        """What a mesh whose model axis or ``fsdp`` splits the worker does
        not hold yet, refused by name."""
        mesh = getattr(self.replicate_fn, "sharded", None)
        if mesh is None:
            return
        name = self.strategy.name
        what = None
        if name not in TP_STRATEGIES:
            what = f"the {name!r} strategy"
        elif getattr(self.strategy, "h_schedule", None) is not None:
            what = "an H schedule (AdaptiveH)"
        elif faults is not None and not faults.empty:
            what = "the fault layer"
        if what is not None:
            axes = " and ".join(a for a, on in (
                ("a model axis > 1", mesh.model > 1),
                ("fsdp over the data axis", mesh.fsdp)) if on)
            raise NotImplementedError(
                f"{what} under {axes}: a sharded worker runs "
                f"{' and '.join(TP_STRATEGIES)} at a fixed H; the rest "
                f"waits for ROADMAP §1's 'configurations the port does not "
                f"yet run'")

    @under_model_axis
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
        self._check_model_axis(faults)
        # a process mesh tags its collective log: the inner steps, and the
        # replay that runs the outer rounds
        rep = self.replicate_fn
        scope = getattr(rep, "scope", lambda name: contextlib.nullcontext())
        is_rank = ranked(rep)
        if rep is not None:
            self._check_processes()
            local, whole = getattr(rep, "local_batch", None), data_fn
            if local is not None:
                def data_fn(step):
                    return local(whole(step))
        # the fleet's loss row: the runner reads it, or a checkpoint does
        fleet = is_rank and (
            getattr(self.strategy, "h_schedule", None) is not None
            or bool(checkpoint_dir))
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
        if rep is not None:
            history.update(inner_seconds=[], sync_seconds=[])
        if fleet:
            history["fleet_loss"] = []
        # each recorded step's worker losses, for a checkpoint's meta
        worker_loss: list = []
        start_step = 0
        if resume:
            manifest = latest_run_checkpoint(checkpoint_dir)
            if manifest is not None:
                template = runner.checkpoint_extras()
                rows = tuple(rep.rows) if is_rank else None
                mesh = getattr(rep, "sharded", None)
                state, extras = load_run_checkpoint(
                    manifest, state,
                    template[0] if template is not None else None,
                    rows=rows, cut=None if mesh is None else mesh.own)
                runner.load_extras(extras, manifest.get("extras_meta") or {})
                for key, vals in (manifest.get("history") or {}).items():
                    history[key] = [_history_from_json(v) for v in vals]
                worker_loss = list(
                    (manifest.get("meta") or {}).get("worker_loss") or [])
                if is_rank:
                    history.update(inner_seconds=[], sync_seconds=[])
                    if fleet:
                        history["fleet_loss"] = list(history["loss"])
                    if len(worker_loss) == len(history["loss"]):
                        # the rank's own worker's, as the run recorded it
                        history["loss"] = [
                            _host_mean(np.asarray(r, np.float32)[list(rows)])
                            for r in worker_loss]
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
                with scope("inner"):
                    for i in range(T):
                        state, loss = eng.inner_step(
                            state, {k: v[i] for k, v in batches.items()},
                            live=live)
                        losses.append(loss)
                del batches
                losses = torch.stack(losses)
                if fleet:
                    # every pod's (T,) row, then the one read
                    with scope("loss"):
                        rows_host = _fetch(rep.fleet_rows(
                            losses.T.contiguous())).T
                    losses_host = rows_host[:, list(rep.rows)]
                else:
                    losses_host = rows_host = _fetch(losses)  # ONE read
                t_inner = time.perf_counter()
                n_synced = _n_syncs(history)
                own_live = eng.local_mask(live)
                with scope("outer"):
                    for i in range(T):
                        s = step + i
                        loss_mean = (_host_mean(losses_host[i])
                                     if own_live is None else
                                     _host_mean_live(losses_host[i],
                                                     own_live))
                        fleet_mean = loss_mean
                        if fleet:
                            fleet_mean = (_host_mean(rows_host[i])
                                          if live is None else
                                          _host_mean_live(rows_host[i], live))
                        if s % record_every == 0:
                            history["step"].append(s)
                            history["loss"].append(loss_mean)
                            if fleet:
                                history["fleet_loss"].append(fleet_mean)
                                worker_loss.append(
                                    [float(x) for x in rows_host[i]])
                        new_state, recs = runner.after_step(state, s,
                                                            fleet_mean)
                        if new_state is not state and s != end:
                            raise RuntimeError(
                                f"sync runner replaced the state at step "
                                f"{s}, mid-chunk (chunk ends at {end}): "
                                f"next_event() must report every step whose "
                                f"after_step touches device state")
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
                if rep is not None:
                    history["inner_seconds"].append((t_inner - t_prev) / T)
                    if _n_syncs(history) > n_synced:
                        history["sync_seconds"].append(t_now - t_inner)
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
                        state = runner.consensus(state)
                        self._save(checkpoint_dir, end + 1, state, extras,
                                   history, worker_loss, num_steps)
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
        with scope("outer"):
            state, recs = runner.finalize(state, num_steps)
        record(recs)
        history["step_seconds"] = sorted(chunk_step_seconds)[
            len(chunk_step_seconds) // 2] if chunk_step_seconds else 0.0
        return state, history

    def _save(self, checkpoint_dir, step, state, extras, history,
              worker_loss, num_steps) -> None:
        """One run checkpoint in the one-process layout (module
        docstring); across ranks rank 0 writes it from the gathered
        rows, the ranks meeting before the manifest and after it."""
        arrays, extras_meta = extras
        rep = self.replicate_fn
        if not ranked(rep):
            save_run_checkpoint(checkpoint_dir, step, state,
                                extras_arrays=arrays, extras_meta=extras_meta,
                                history=history, meta={"num_steps": num_steps})
            return
        mesh = getattr(rep, "sharded", None)
        if mesh is not None:
            # the model ranks' shards joined at model index 0 first (every
            # rank, the same leaves in the same order), then under fsdp
            # the data ranks' among the model-index-0 ranks; the pod
            # gather below runs among the ranks at data and model index 0
            # alone (or every data index, when the data axis replicates)
            def joiner(split, gather):
                def join(path, t):
                    dim = (split(path) if isinstance(t, torch.Tensor)
                           else None)
                    return t if dim is None else gather(t, dim)
                return join

            with rep.scope("checkpoint"):
                for split, gather, off in (
                        (mesh.split_dim, mesh.model_gather,
                         mesh.model_index),
                        (mesh.data_split_dim, mesh.data_all_gather,
                         mesh.data_index if mesh.fsdp else 0)):
                    join = joiner(split, gather)
                    state = _rebuild(state, join)
                    arrays = _rebuild(arrays, join)
                    if off:
                        break
            if mesh.model_index or (mesh.fsdp and mesh.data_index):
                rep.barrier()   # the checkpoint's files are written
                rep.barrier()   # the manifest is written
                return
        full = _one_process_state(state, rep)
        arrays = _one_process_extras(arrays, rep)
        if rep.lead:
            hist = {k: v for k, v in history.items() if k not in _RANK_KEYS}
            hist["loss"] = list(history["fleet_loss"])
            save_run_checkpoint(checkpoint_dir, step, full,
                                extras_arrays=arrays, extras_meta=extras_meta,
                                history=hist,
                                meta={"num_steps": num_steps,
                                      "worker_loss": worker_loss},
                                before_manifest=rep.barrier)
        else:
            rep.barrier()
        rep.barrier()           # the manifest is written
