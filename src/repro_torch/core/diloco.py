"""DiLoCo trainer (the JAX package's ``core/diloco.py``).

    each worker:  H inner steps (nanochat's Muon + AdamW)
    every H:      average parameter deltas, outer Nesterov SGD, re-broadcast

The JAX package stacks the K workers on a leading dim and ``vmap``s one
worker's step.  Here the K workers are a Python loop over separate flat
parameter dicts on one device: a stacked (K, ...) copy would need every
worker's activations and gradients alive at once (about 12 GB per worker
at nanochat-d20 and 4 x 1024 tokens), while the loop frees each worker's
graph before the next worker runs.  The arithmetic of each worker is
the same either way.

Parameters are flat dicts ``{manifest path: tensor}``; the loss function
takes the nested tree (``unflatten``), as ``models.lm_loss`` does.  Worker
parameters are updated IN PLACE by the inner step (the JAX package returns
new arrays), and the outer step writes the new anchor into every worker's
tensors, so a worker holds one copy of its parameters throughout.

The outer step goes through the codec transport (``core/transport.py``):
f32, bf16, or int8 / fp8 / fp8_e5m2 through the quantize kernels, with a
per-worker error-feedback residual (``init_residual``) that the sync
runner holds beside the state.  The anchor and the outer momentum are
updated in place too.

The fault layer's rounds are the same ``sync`` under (K,) masks of the
``core/faults.py`` tracker: only contributors ship and are averaged,
adopters take the anchor, rejoiners take it with a fresh optimizer state
and a zero residual, the dead keep their bits (``outer_step_quorum``,
``adopt_anchor``); a dead worker is not stepped (``inner_step(live=)``).

The DDP baseline (``core/ddp.py``, and ``DDPSync`` in ``core/sync.py``) is
the same inner step with K = 1 on the global batch.
"""
from __future__ import annotations

import dataclasses
from typing import (Any, Callable, Dict, List, NamedTuple, Optional,
                    Sequence, Tuple)

import torch

from repro_torch.configs.base import DiLoCoConfig, OptimizerConfig
from repro_torch.core import outer_opt
from repro_torch.core.outer_opt import OuterState
from repro_torch.core.transport import make_codec
from repro_torch.models.transformer import flatten, unflatten
from repro_torch.optim import Optimizer, apply_updates, nanochat_optimizer

Flat = Dict[str, torch.Tensor]
# leaf -> the rows of its leading dim in a fragment (slice(None): the
# whole leaf), or None when the leaf is not in it
Fragment = Dict[str, Optional[slice]]


class DiLoCoState(NamedTuple):
    global_params: Flat        # θ_t — the synchronized snapshot
    outer: OuterState
    worker_params: List[Flat]  # K per-worker copies, updated in place
    inner_opt: List[Any]       # K per-worker inner optimizer states
    inner_step: torch.Tensor   # total inner steps taken (0-d int32)


def worker_step(loss_fn: Callable, opt: Optimizer, params: Flat, opt_state,
                batch: Dict[str, torch.Tensor], step: torch.Tensor
                ) -> Tuple[Any, torch.Tensor]:
    """One inner step of one worker: loss and gradients of ``loss_fn`` at
    ``params`` on ``batch``, the optimizer's update, applied to ``params``
    in place.  The autograd graph is freed before the optimizer runs.
    Returns (new optimizer state, loss as a 0-d tensor on the device)."""
    leaves = {k: p.detach().requires_grad_(True) for k, p in params.items()}
    loss, _ = loss_fn(unflatten(leaves), batch)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    del leaves
    updates, opt_state = opt.update(dict(zip(params, grads)), opt_state,
                                    params, step)
    del grads
    apply_updates(params, updates)
    return opt_state, loss.detach()


@dataclasses.dataclass(frozen=True)
class DiLoCoTrainer:
    """loss_fn(params tree, batch) -> (loss, metrics-dict)."""
    loss_fn: Callable
    opt_cfg: OptimizerConfig
    cfg: DiLoCoConfig

    def _inner_opt(self) -> Optimizer:
        return nanochat_optimizer(self.opt_cfg)

    # -- construction -------------------------------------------------------
    def init(self, params) -> DiLoCoState:
        """``params``: a nested tree (or flat dict); it is copied, never
        written.  All state lives on the parameters' device."""
        with torch.no_grad():
            anchor = {k: p.detach().clone()
                      for k, p in flatten(params).items()}
            workers = [{k: p.clone() for k, p in anchor.items()}
                       for _ in range(self.cfg.num_workers)]
        inner = self._inner_opt()
        device = next(iter(anchor.values())).device
        return DiLoCoState(
            global_params=anchor,
            outer=outer_opt.init_outer_state(anchor),
            worker_params=workers,
            inner_opt=[inner.init(w) for w in workers],
            inner_step=torch.zeros((), dtype=torch.int32, device=device))

    # -- inner step ----------------------------------------------------------
    def inner_step(self, state: DiLoCoState, batches: Dict[str, torch.Tensor],
                   live: Optional[Sequence[bool]] = None
                   ) -> Tuple[DiLoCoState, torch.Tensor]:
        """batches: tensors with a leading (K, ...) worker dim.  Runs the
        workers one after another; returns (state, (K,) losses on the
        device).  ``live`` (a (K,) mask; None: every worker) leaves the
        dead workers out: they are not stepped, so their parameters and
        optimizer states keep their bits (the reference computes their
        step and discards it, the same state), and their loss entries are
        NaN.  The shared step counter advances either way."""
        opt = self._inner_opt()
        new_opt, losses = [], []
        for w, params in enumerate(state.worker_params):
            if live is not None and not live[w]:
                new_opt.append(state.inner_opt[w])
                losses.append(torch.full((), float("nan"),
                                         device=state.inner_step.device))
                continue
            batch = {k: v[w] for k, v in batches.items()}
            opt_state, loss = worker_step(self.loss_fn, opt, params,
                                          state.inner_opt[w], batch,
                                          state.inner_step)
            new_opt.append(opt_state)
            losses.append(loss)
        return (state._replace(inner_opt=new_opt,
                               inner_step=state.inner_step + 1),
                torch.stack(losses))

    # -- outer step ----------------------------------------------------------
    def init_residual(self, params) -> Optional[Flat]:
        """Per-worker (K, ...) f32 error-feedback residual of each leaf for
        lossy codecs, or None when the codec is lossless or error feedback
        is off.  Held by the sync runners, not in ``DiLoCoState``."""
        if not (self.cfg.error_feedback
                and make_codec(self.cfg.delta_dtype).lossy):
            return None
        return {k: torch.zeros((self.cfg.num_workers,) + tuple(p.shape),
                               dtype=torch.float32, device=p.device)
                for k, p in flatten(params).items()}

    @torch.no_grad()
    def sync(self, state: DiLoCoState, residual: Optional[Flat] = None, *,
             frag: Optional[Fragment] = None,
             snapshot: Optional[List[Flat]] = None, fragment: int = -1,
             contrib: Optional[Sequence[bool]] = None,
             adopt: Optional[Sequence[bool]] = None,
             reset: Optional[Sequence[bool]] = None
             ) -> Tuple[DiLoCoState, Optional[Flat]]:
        """One outer round through the codec transport.

        ``frag`` (``core/streaming.py fragment_masks``) names the rows of
        each leaf's leading dim that take part (None: every leaf, whole);
        the outer momentum of the rest decays as under a zero delta, as
        the reference's whole-tree update does.  ``snapshot`` (K dicts of
        the selected slices, taken earlier) supplies the deltas instead of
        the workers, and the workers then carry forward the progress made
        since: worker = new anchor + (worker − snapshot).  Without a
        snapshot the workers take the new anchor (their inner optimizer
        states stay per worker, paper §3).  The anchor, momentum, residual
        and workers are updated in place.  Returns (state, residual).

        A quorum round (the fault layer) passes three (K,) masks:
        ``contrib`` rows ship and enter the average (the rest keep their
        residual rows); ``adopt`` rows take the round as above; ``reset``
        rows (rejoiners) take the WHOLE new anchor, every leaf, with a
        fresh inner optimizer state and a zero residual; rows in none
        pass through frozen.  With every mask all-true this is the
        unmasked round, bit for bit."""
        gp, v = state.global_params, state.outer.v
        sel = ({k: slice(None) for k in gp} if frag is None else
               {k: sl for k, sl in frag.items() if sl is not None})
        rows = {k: ([w[k][sl] for w in state.worker_params]
                    if snapshot is None else [s[k] for s in snapshot])
                for k, sl in sel.items()}
        outer_opt.outer_sync(
            {k: gp[k][sl] for k, sl in sel.items()}, rows,
            {k: v[k][sl] for k, sl in sel.items()}, self.cfg,
            None if residual is None else
            {k: residual[k][:, sl] for k, sl in sel.items()},
            kind="delta" if frag is None else "fragment", fragment=fragment,
            contrib=contrib)
        if frag is not None:
            mu = self.cfg.outer_momentum
            for k, vk in v.items():
                sl = frag.get(k)
                if sl is None:
                    vk.mul_(mu)
                elif sl != slice(None):
                    vk[:sl.start].mul_(mu)
                    vk[sl.stop:].mul_(mu)
        for i, params in enumerate(state.worker_params):
            if adopt is not None and not adopt[i]:
                continue
            for k, sl in sel.items():
                w = params[k][sl]
                if snapshot is None:
                    w.copy_(gp[k][sl])
                else:
                    w.copy_(gp[k][sl].float()
                            + (w.float() - snapshot[i][k].float()))
        if reset is not None and any(reset):
            state = self._reset_rows(state, residual, reset)
        return (state._replace(outer=state.outer._replace(
            t=state.outer.t + 1)), residual)

    def _reset_rows(self, state: DiLoCoState, residual: Optional[Flat],
                    reset: Sequence[bool]) -> DiLoCoState:
        """Rejoiners: ``reset`` rows take the whole current anchor, a
        fresh inner optimizer state (``init`` of their new parameters: the
        reference zeroes the moments, which start at zero) and a zero
        error-feedback residual, in place."""
        gp = state.global_params
        for i, params in enumerate(state.worker_params):
            if not reset[i]:
                continue
            for k, w in params.items():
                w.copy_(gp[k])
            if residual is not None:
                for r in residual.values():
                    r[i].zero_()
        return self.init_inner(state, reset)

    def init_inner(self, state: DiLoCoState,
                   rows: Sequence[bool]) -> DiLoCoState:
        """A fresh inner optimizer state (``init`` of the current
        parameters) for each worker that ``rows`` marks."""
        if not any(rows):
            return state
        opt = self._inner_opt()
        return state._replace(inner_opt=[
            opt.init(state.worker_params[i]) if r else o
            for i, (r, o) in enumerate(zip(rows, state.inner_opt))])

    def outer_step_ef(self, state: DiLoCoState,
                      residual: Optional[Flat] = None
                      ) -> Tuple[DiLoCoState, Optional[Flat]]:
        """Full outer sync with an optional error-feedback residual;
        returns (state, residual)."""
        return self.sync(state, residual)

    def outer_step(self, state: DiLoCoState) -> DiLoCoState:
        return self.outer_step_ef(state)[0]

    # -- quorum outer step + elastic rejoin (the fault layer) ---------------
    def outer_step_quorum(self, state: DiLoCoState, residual: Optional[Flat],
                          contrib: Sequence[bool], adopt: Sequence[bool],
                          reset: Sequence[bool]
                          ) -> Tuple[DiLoCoState, Optional[Flat]]:
        """``outer_step_ef`` under the quorum masks of ``sync``: ``contrib``
        rows are averaged, ``adopt`` rows take the new anchor and keep
        their inner optimizer state, ``reset`` rows take it with a fresh
        optimizer state and residual, dead rows pass through frozen."""
        return self.sync(state, residual, contrib=contrib, adopt=adopt,
                         reset=reset)

    @torch.no_grad()
    def adopt_anchor(self, state: DiLoCoState, residual: Optional[Flat],
                     reset: Sequence[bool]
                     ) -> Tuple[DiLoCoState, Optional[Flat]]:
        """Rejoin without a round (quorum skipped): ``reset`` rows adopt
        the CURRENT anchor with a fresh inner optimizer state and a zero
        residual; the anchor and the outer momentum are untouched."""
        return self._reset_rows(state, residual, reset), residual
