"""The distributed-training loop (the JAX package's
``core/dist_trainer.py``, without faults, checkpoints, prefetch or evals).

    trainer = DistTrainer(loss_fn, opt_cfg, dcfg, DiLoCoSync())
    state = trainer.init(params)
    state, hist = trainer.run(state, data_fn, num_steps)

The strategy owns when and what to synchronize (and holds the codec's
error-feedback residual); the loop runs the inner steps, records losses
and builds the history: ``step`` / ``loss``, ``sync_steps``,
``frag_syncs`` and ``evals`` (always empty here, kept so the keys match
the JAX package's) and ``step_seconds`` (median seconds per inner step
over chunks).

Chunks.  A chunk runs from the current step to the strategy's next event
(the next outer sync for DiLoCo), at most ``MAX_CHUNK`` steps.  The
inner steps of a chunk are enqueued back to back; their (T, K) losses stay
on the device and are read back ONCE per chunk, then the runner's
``after_step`` is replayed per step on the host with fixed-order means.
``chunked=False`` reads the losses after every step instead.  The device
work is the same either way, so both give the same losses and
parameters bit for bit.

The state passed to ``run`` is updated in place (worker parameters and
optimizer states) and returned; make a fresh one with ``init`` per run.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import DiLoCoConfig, OptimizerConfig
from repro_torch.core.diloco import DiLoCoState
from repro_torch.core.streaming import StreamingDiLoCoTrainer
from repro_torch.core.sync import SyncStrategy


# the longest chunk: how many steps' losses may wait on the device
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


def _to_device(batch: Dict, device: torch.device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


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
            eval_fn: Optional[Callable] = None, eval_every: int = 0, *,
            chunked: bool = True, prefetch: int = 0, faults=None,
            checkpoint_dir: Optional[str] = None, checkpoint_every: int = 0,
            resume: bool = False) -> Tuple[DiLoCoState, Dict]:
        """data_fn(step) -> per-worker-stacked batch {name: (K, B, S)}
        (numpy or tensors); moved to the parameters' device here."""
        if eval_fn is not None or eval_every:
            raise NotImplementedError("eval hooks are not ported")
        if prefetch:
            raise NotImplementedError("prefetch is not ported")
        if faults is not None and not getattr(faults, "empty", False):
            raise NotImplementedError("fault injection is not ported")
        if checkpoint_dir or checkpoint_every or resume:
            raise NotImplementedError("run checkpoints and resume are not "
                                      "ported")
        eng = self.engine()
        runner = self.strategy.bind(eng, state.global_params)
        device = state.inner_step.device
        history: Dict[str, list] = {"step": [], "loss": [], "sync_steps": [],
                                    "frag_syncs": [], "evals": []}
        chunk_step_seconds = []
        step = 0
        t_prev = time.perf_counter()
        while step < num_steps:
            end = num_steps - 1
            if chunked:
                event = runner.next_event(step)
                if event is not None:
                    end = min(end, max(event, step))
                end = min(end, step + MAX_CHUNK - 1)
            else:
                end = step
            losses = []
            for s in range(step, end + 1):
                state, loss = eng.inner_step(state,
                                             _to_device(data_fn(s), device))
                losses.append(loss)
            losses_host = _fetch(torch.stack(losses))   # ONE read per chunk
            for i in range(end - step + 1):
                s = step + i
                loss_mean = _host_mean(losses_host[i])
                history["step"].append(s)
                history["loss"].append(loss_mean)
                new_state, recs = runner.after_step(state, s, loss_mean)
                if new_state is not state and s != end:
                    raise RuntimeError(
                        f"sync runner replaced the state at step {s}, "
                        f"mid-chunk (chunk ends at {end}): next_event() must "
                        f"report every step whose after_step touches device "
                        f"state")
                state = new_state
                for key, val in recs:
                    history.setdefault(key, []).append(val)
            if device.type == "cuda":
                torch.cuda.synchronize(device)   # an outer sync is timed too
            t_now = time.perf_counter()
            chunk_step_seconds.append((t_now - t_prev) / (end - step + 1))
            t_prev = t_now
            step = end + 1
        state, recs = runner.finalize(state, num_steps)
        for key, val in recs:
            history.setdefault(key, []).append(val)
        history["step_seconds"] = sorted(chunk_step_seconds)[
            len(chunk_step_seconds) // 2] if chunk_step_seconds else 0.0
        return state, history
