"""DiLoCo trainer (the JAX package's ``core/diloco.py``).

    each worker:  H inner steps (nanochat's Muon + AdamW)
    every H:      average parameter deltas, outer Nesterov SGD, re-broadcast

The JAX package stacks the K workers on a leading dim and ``vmap``s one
worker's step, and on a pod mesh shards that dim over ``pod``.  Here the
workers a process holds are a Python loop over separate flat parameter
dicts: a stacked (K, ...) copy would need every worker's activations and
gradients alive at once (about 12 GB per worker at nanochat-d20 and 4 x
1024 tokens), while the loop frees each worker's graph before the next
worker runs.  The arithmetic of each worker is the same either way.

On one device the process holds all K workers.  As one rank of a process
mesh (``launch/mesh.py``: ``replicate_fn=mesh.replicate_fn``) it holds
its own worker's row only (``local_rows``): its parameters, its inner
optimizer state and its error-feedback residual row; the batches it is
given are its own (``DistTrainer.run`` cuts them); over a data axis its
gradients are all-reduced across the pod's data ranks before the
optimizer runs (``worker_step(grad_reduce=)``); the anchor and the outer
momentum are replicated, and the outer round all-gathers the encoded
rows across pods (``core/transport.py``).  The inner step issues no
collective across pods.

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

Tensor parallelism.  On a mesh with a ``model`` axis > 1
(``replicate_fn.tp``) a worker is split over its model group: ``init``
cuts the one-process parameters to this rank's shards
(``models.sharding.shard``), and the inner steps and rounds run under
the mesh's model axis (``models.tensor_parallel.use``), which the layers
reduce over; the inner optimizer (the global norm, Muon) and the
transport's codec (the wire's scales) take the mesh as their ``axis``;
the outer step and AdamW are elementwise on the shards.  Each state
tensor is this rank's shard of the one-process tensor;
``init_residual`` takes the state's (sharded) parameters.

ZeRO-3 over the data axis.  On a mesh with ``fsdp``
(``replicate_fn.sharded``) the pod's data ranks split the worker as
well: ``init`` cuts each leaf's ``fsdp`` dim too (``ProcessMesh.own``),
so the parameters, AdamW's moments, Muon's momentum, the anchor, the
outer momentum and the residual are all shards; the steps run under the
mesh's data axis (``models.fsdp.use``), whose layers gather their
weights and reduce-scatter their gradients, ``grad_reduce`` all-reduces
the whole leaves only, and the optimizer and codec reduce over both
groups.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import (Any, Callable, Dict, List, NamedTuple, Optional,
                    Sequence, Tuple)

import torch

from repro_torch.configs.base import DiLoCoConfig, OptimizerConfig
from repro_torch.core import outer_opt
from repro_torch.core.outer_opt import OuterState
from repro_torch.core.transport import make_codec, wire_width
from repro_torch.models import fsdp
from repro_torch.models import tensor_parallel as tp
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


def own_params(params, replicate_fn=None) -> Flat:
    """A copy of ``params`` (a tree or flat dict, one-process layout, never
    written) as this process holds it: whole, or cut to this rank's
    shards on a mesh whose model axis or ``fsdp`` splits the worker."""
    with torch.no_grad():
        flat = {k: p.detach() for k, p in flatten(params).items()}
        mesh = getattr(replicate_fn, "sharded", None)
        if mesh is None:
            return {k: p.clone() for k, p in flat.items()}
        if set(flat) != set(mesh.layout or mesh.data_layout):
            raise ValueError("the parameters are not the tree the mesh's "
                             "layout was made for (init_process_mesh(cfg=))")
        return mesh.own(flat)


def under_model_axis(method):
    """Run a trainer's method under its mesh's model axis
    (``tensor_parallel.use``) and ``fsdp`` data axis (``fsdp.use``); no
    axis without them."""
    @functools.wraps(method)
    def run(self, *args, **kw):
        rep = self.replicate_fn
        with tp.use(getattr(rep, "tp", None)), \
                fsdp.use(getattr(rep, "sharded", None)):
            return method(self, *args, **kw)
    return run


def worker_step(loss_fn: Callable, opt: Optimizer, params: Flat, opt_state,
                batch: Dict[str, torch.Tensor], step: torch.Tensor,
                grad_reduce: Optional[Callable] = None
                ) -> Tuple[Any, torch.Tensor]:
    """One inner step of one worker: loss and gradients of ``loss_fn`` at
    ``params`` on ``batch``, the optimizer's update, applied to ``params``
    in place.  The autograd graph is freed before the optimizer runs.
    ``grad_reduce`` (``{path: grad} -> {path: grad}``; DDP over a data
    axis: the mean over the data ranks) runs on the gradients before the
    optimizer.  Returns (new optimizer state, loss as a 0-d tensor on the
    device: this process's batch's)."""
    leaves = {k: p.detach().requires_grad_(True) for k, p in params.items()}
    loss, _ = loss_fn(unflatten(leaves), batch)
    grads = dict(zip(params, torch.autograd.grad(loss,
                                                 list(leaves.values()))))
    del leaves
    if grad_reduce is not None:
        grads = grad_reduce(grads)
    updates, opt_state = opt.update(grads, opt_state, params, step)
    del grads
    apply_updates(params, updates)
    return opt_state, loss.detach()


@dataclasses.dataclass(frozen=True)
class DiLoCoTrainer:
    """loss_fn(params tree, batch) -> (loss, metrics-dict).
    ``replicate_fn``: the replicate hop of a process mesh
    (``launch.mesh.ProcessMesh.replicate_fn``), None on one device."""
    loss_fn: Callable
    opt_cfg: OptimizerConfig
    cfg: DiLoCoConfig
    replicate_fn: Optional[Callable] = None

    def _inner_opt(self) -> Optimizer:
        return nanochat_optimizer(
            self.opt_cfg, axis=getattr(self.replicate_fn, "sharded", None))

    @property
    def local_rows(self) -> Tuple[int, ...]:
        """The worker rows this process holds: all K on one device, its
        own row (``replicate_fn.rows``) as one rank of a process mesh."""
        rows = getattr(self.replicate_fn, "rows", None)
        return tuple(range(self.cfg.num_workers)) if rows is None \
            else tuple(rows)

    def local_mask(self, mask: Optional[Sequence[bool]]
                   ) -> Optional[Tuple[bool, ...]]:
        """A (K,) worker mask's entries for the rows this process holds
        (``local_rows``); every entry on one device."""
        return None if mask is None else tuple(mask[w]
                                               for w in self.local_rows)

    # -- construction -------------------------------------------------------
    def init(self, params) -> DiLoCoState:
        """``params``: a nested tree (or flat dict); it is copied, never
        written.  All state lives on the parameters' device; one worker
        copy per local row (``local_rows``)."""
        anchor = own_params(params, self.replicate_fn)
        with torch.no_grad():
            workers = [{k: p.clone() for k, p in anchor.items()}
                       for _ in self.local_rows]
        inner = self._inner_opt()
        device = next(iter(anchor.values())).device
        return DiLoCoState(
            global_params=anchor,
            outer=outer_opt.init_outer_state(anchor),
            worker_params=workers,
            inner_opt=[inner.init(w) for w in workers],
            inner_step=torch.zeros((), dtype=torch.int32, device=device))

    # -- inner step ----------------------------------------------------------
    @under_model_axis
    def inner_step(self, state: DiLoCoState, batches: Dict[str, torch.Tensor],
                   live: Optional[Sequence[bool]] = None
                   ) -> Tuple[DiLoCoState, torch.Tensor]:
        """batches: tensors with a leading worker dim, one row per local
        worker (K on one device).  Runs the workers one after another;
        returns (state, (K,) losses on the device).  ``live`` (a (K,)
        mask; None: every worker) leaves the dead workers out: they are
        not stepped, so their parameters and
        optimizer states keep their bits (the reference computes their
        step and discards it, the same state), and their loss entries are
        NaN.  The shared step counter advances either way.  Each worker's
        new optimizer state replaces its old one in ``state.inner_opt`` as
        it lands (the state is consumed), so at most one worker's old
        state is alive at a time."""
        opt = self._inner_opt()
        grad_reduce = getattr(self.replicate_fn, "grad_reduce", None)
        live = self.local_mask(live)
        states, losses = state.inner_opt, []
        for w, params in enumerate(state.worker_params):
            if live is not None and not live[w]:
                losses.append(torch.full((), float("nan"),
                                         device=state.inner_step.device))
                continue
            batch = {k: v[w] for k, v in batches.items()}
            states[w], loss = worker_step(self.loss_fn, opt, params,
                                          states[w], batch,
                                          state.inner_step, grad_reduce)
            losses.append(loss)
        return (state._replace(inner_opt=list(states),
                               inner_step=state.inner_step + 1),
                torch.stack(losses))

    # -- outer step ----------------------------------------------------------
    def init_residual(self, params) -> Optional[Flat]:
        """Per-worker (K, ...) f32 error-feedback residual of each leaf for
        lossy codecs (a row per local worker), or None when the codec is
        lossless or error feedback is off.  Held by the sync runners, not
        in ``DiLoCoState``."""
        if not (self.cfg.error_feedback
                and make_codec(self.cfg.delta_dtype).lossy):
            return None
        return {k: torch.zeros((len(self.local_rows),) + tuple(p.shape),
                               dtype=torch.float32, device=p.device)
                for k, p in flatten(params).items()}

    @torch.no_grad()
    @under_model_axis
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
        unmasked round, bit for bit.  The masks index the K workers; a
        rank of a process mesh applies the entries of its own rows."""
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
            contrib=contrib, replicate_fn=self.replicate_fn)
        if frag is not None:
            mu = self.cfg.outer_momentum
            for k, vk in v.items():
                sl = frag.get(k)
                if sl is None:
                    vk.mul_(mu)
                elif sl != slice(None):
                    vk[:sl.start].mul_(mu)
                    vk[sl.stop:].mul_(mu)
        adopt = self.local_mask(adopt)
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
        local = self.local_mask(reset)
        for i, params in enumerate(state.worker_params):
            if not local[i]:
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
        parameters) for each worker that ``rows`` (a (K,) mask) marks."""
        rows = self.local_mask(rows)
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

    # -- communication accounting (paper: "communication reduced ~100x") ----
    def bytes_per_sync(self, params) -> int:
        """Bytes each worker ships per outer sync (payload dtype)."""
        n = sum(p.numel() for p in flatten(params).values())
        return n * wire_width(self.cfg.delta_dtype)

    def ddp_bytes_per_step(self, params) -> int:
        """What synchronous DDP would ship per *inner* step (f32 grads)."""
        return sum(p.numel() for p in flatten(params).values()) * 4


# ---------------------------------------------------------------------------
# Training loop: a thin wrapper over the DistTrainer runtime
# ---------------------------------------------------------------------------

def run_diloco(trainer: DiLoCoTrainer, state: DiLoCoState, data_fn,
               num_steps: int, h_schedule=None, record_every: int = 1,
               eval_fn: Optional[Callable] = None,
               eval_every: int = 0) -> Tuple[DiLoCoState, Dict]:
    """data_fn(step) -> per-worker-stacked batch {name: (K, B, S)}.

    ``h_schedule`` decides when to synchronize (default: fixed H from the
    config), e.g. the adaptive-H controller.  ``state`` is updated in
    place and returned with the history (``DistTrainer.run``)."""
    from repro_torch.core.dist_trainer import DistTrainer
    from repro_torch.core.sync import DiLoCoSync
    dt = DistTrainer(trainer.loss_fn, trainer.opt_cfg, trainer.cfg,
                     DiLoCoSync(h_schedule=h_schedule), trainer.replicate_fn)
    return dt.run(state, data_fn, num_steps, record_every=record_every,
                  eval_fn=eval_fn, eval_every=eval_every)
