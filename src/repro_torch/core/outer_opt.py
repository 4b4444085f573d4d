"""DiLoCo outer synchronization: delta exchange through the codec
transport, averaging, and Nesterov outer SGD (the JAX package's
``core/outer_opt.py``).

    Δθ_i    = θ_i^H − θ_t          (per-worker parameter delta, f32)
    Δθ̄      = (1/k) Σ_i decode(encode(Δθ_i))   (the communication)
    v_{t+1} = μ v_t + Δθ̄
    θ_{t+1} = θ_t + η (Δθ̄ + μ v_{t+1})   (Nesterov; else θ_t + η v_{t+1})

The exchange itself is ``core/transport.py``: f32 passthrough, bf16 cast,
or int8 / fp8 / fp8_e5m2 with per-tensor-per-worker scales through the
quantize kernels, with an optional per-worker error-feedback residual.

On a process mesh (a ``replicate_fn``, ``launch/mesh.py``) a rank holds
its own worker's rows only: it encodes them, the transport all-gathers
every worker's encoded rows across pods, and every rank decodes and
averages all K in worker order, so the anchor and momentum are the
one-process round's bit for bit.  Where the mesh's model axis or
``fsdp`` splits a worker, the rows, anchor, momentum and residual are
this rank's shards; the round is elementwise on them, and drift-aware
averaging sums its cosines' partial sums over the splitting groups.

``outer_sync`` runs the round one leaf at a time: it stacks one leaf's K
worker deltas, encodes, ships, decodes and averages them, and applies the
outer update to that leaf before it touches the next, so no (K, ...)
stack of the whole model is held.  Leaves are independent, so this gives
the reference's whole-tree result bit for bit.  Drift-aware averaging
weighs each worker by the cosine of its WHOLE delta to the mean, which
needs every leaf first: that path decodes all leaves, then averages.
"""
from __future__ import annotations

from typing import (Callable, Dict, List, NamedTuple, Optional, Sequence,
                    Tuple)

import torch

from repro_torch.configs.base import DiLoCoConfig
from repro_torch.core.transport import (QuantizedCodec, Transport,
                                        make_codec, ranked, wire_width)
from repro_torch.kernels.quantize.ref import reference_quantize_ef

Flat = Dict[str, torch.Tensor]

# wire width (bytes/element) of each supported delta payload dtype
DELTA_WIDTH = {d: wire_width(d)
               for d in ("float32", "bfloat16", "int8", "fp8", "fp8_e5m2")}


class OuterState(NamedTuple):
    v: Flat               # outer momentum, f32, one leaf per parameter
    t: torch.Tensor       # outer step counter, 0-d int32


def init_outer_state(params: Flat) -> OuterState:
    some = next(iter(params.values()))
    return OuterState(
        v={k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
           for k, p in params.items()},
        t=torch.zeros((), dtype=torch.int32, device=some.device))


def make_transport(cfg: DiLoCoConfig,
                   replicate_fn: Optional[Callable] = None) -> Transport:
    """The transport the config describes: the quantize kernels on CUDA
    tensors, their plain versions on CPU tensors; ``replicate_fn`` the
    replicate hop across processes (None on one card)."""
    return Transport(make_codec(cfg.delta_dtype), replicate_fn)


def quantize_delta(delta: Flat, dtype: str):
    """Per-tensor symmetric quantization of a (K, ...) stacked delta dict
    through the plain per-row oracle (an f32 or bf16 wire is a cast, with
    no scales).  Returns (payload, scales) dicts."""
    codec = make_codec(dtype)
    if not isinstance(codec, QuantizedCodec):
        payload, _ = codec.encode(delta)
        return payload.data, payload.scales
    out = {k: reference_quantize_ef(d, dtype=codec.qdtype)
           for k, d in delta.items()}
    return ({k: q for k, (q, _, _) in out.items()},
            {k: s for k, (_, _, s) in out.items()})


def dequantize_delta(payload: Flat, scales: Optional[Flat]) -> Flat:
    if scales is None:
        return {k: p.float() for k, p in payload.items()}
    return {k: p.float() * scales[k] for k, p in payload.items()}


# ---------------------------------------------------------------------------
# Averaging
# ---------------------------------------------------------------------------

def _drift_dots(delta: Flat, mean: Flat, axis=None):
    """The drift-aware weights' tree sums: (|Δ̄|², [|Δ_i|²], [Δ_i·Δ̄]),
    each a sum over the leaves in dict order of the leaf's own sum.  With
    an ``axis`` (a process mesh whose model axis or ``fsdp`` splits the
    leaves) a split leaf's partial sums are summed over every group that
    splits it first (one all-reduce a group of the stacked per-leaf
    partials, ``reduce_leaves``), and a whole leaf counts once."""
    keys = list(delta)
    k_workers = delta[keys[0]].shape[0]
    parts = []
    for k in keys:
        m = mean[k]
        sums = [torch.sum(m.float() * m.float())]
        sums += [torch.sum(delta[k][i].float() * delta[k][i].float())
                 for i in range(k_workers)]
        sums += [torch.sum(delta[k][i].float() * m.float())
                 for i in range(k_workers)]
        parts.append(torch.stack(sums))
    if axis is not None:
        parts = axis.reduce_leaves(keys, parts)
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    return (total[0], total[1:1 + k_workers], total[1 + k_workers:])


def drift_weights(delta: Flat, mean: Flat, axis=None) -> torch.Tensor:
    """Drift-aware averaging's (K,) weights softmax(4 · cos(Δ_i, Δ̄)) of
    stacked (K, ...) deltas and their mean, over the whole tree
    (``_drift_dots``; ``axis``: its)."""
    mm, dd, dm = _drift_dots(delta, mean, axis)
    mean_norm = torch.sqrt(mm) + 1e-12
    cos = dm / ((torch.sqrt(dd) + 1e-12) * mean_norm)
    return torch.softmax(4.0 * cos, dim=0)


def _mean(d: torch.Tensor) -> torch.Tensor:
    """Mean over the leading worker dim, summed in worker order (for K=2
    exactly the reference's ``jnp.mean``)."""
    acc = d[0]
    for i in range(1, d.shape[0]):
        acc = acc + d[i]
    return acc / d.shape[0]


def _average(delta: Flat, cfg: DiLoCoConfig,
             live: Optional[Sequence[bool]] = None, axis=None) -> Flat:
    """Decoded f32 (K, ...) stacked deltas -> averaged delta dict; with
    ``drift_aware`` each worker is weighted by softmax(4 · cos(Δ_i, Δ̄))
    over the whole dict.

    ``live`` is the quorum round's (K,) contribution mask: only its rows
    enter the mean (and the drift-aware weights, where the reference
    gives the rest -inf logits).  They are picked out before the same
    expressions run, so the masked mean IS the plain mean of the
    survivors, bit for bit, and an all-live mask is the unmasked
    average.  ``live=None`` is the unmasked average.  ``axis`` (a process
    mesh whose model axis or ``fsdp`` splits the leaves: ``delta`` holds
    this rank's shards) sums the cosines' partial sums over the groups
    that split each leaf (``_drift_dots``), so the weights are the whole
    tree's on every rank."""
    if live is not None and not all(live):
        rows = [i for i, keep in enumerate(live) if keep]
        if not rows:
            return {k: torch.zeros_like(d[0]) for k, d in delta.items()}
        idx = torch.tensor(rows, dtype=torch.long,
                           device=next(iter(delta.values())).device)
        delta = {k: d.index_select(0, idx) for k, d in delta.items()}
    mean = {k: _mean(d) for k, d in delta.items()}
    if not cfg.drift_aware:
        return mean
    w = drift_weights(delta, mean, axis)                      # (K,)
    return {k: torch.tensordot(w, d.float(), dims=([0], [0]))
            for k, d in delta.items()}


def exchange_and_average(stacked_delta: Flat, cfg: DiLoCoConfig,
                         residual: Optional[Flat] = None,
                         kind: str = "delta", fragment: int = -1,
                         live: Optional[Sequence[bool]] = None,
                         replicate_fn: Optional[Callable] = None,
                         sources: Optional[Sequence[int]] = None
                         ) -> Tuple[Flat, Optional[Flat]]:
    """encode -> ship -> decode -> average; returns (averaged delta, new
    error-feedback residual or None).  ``live`` is the quorum round's
    contribution mask (``_average``); with ``replicate_fn``
    ``stacked_delta`` and ``residual`` are this process's rows only, and
    ``sources`` (``Transport.ship``'s) the workers whose rows cross."""
    full, new_residual = make_transport(cfg, replicate_fn).exchange(
        stacked_delta, residual, kind=kind, fragment=fragment,
        sources=sources)
    return (_average(full, cfg, live=live,
                     axis=getattr(replicate_fn, "sharded", None)),
            new_residual)


# ---------------------------------------------------------------------------
# Outer update
# ---------------------------------------------------------------------------

def update_leaf(p: torch.Tensor, v: torch.Tensor, d: torch.Tensor,
                cfg: DiLoCoConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Nesterov-momentum SGD on one leaf's averaged delta (the
    pseudo-gradient is −Δθ̄).  Returns (new parameter, new momentum)."""
    mu, eta = cfg.outer_momentum, cfg.outer_lr
    d = d.float()
    v_new = mu * v + d
    step_dir = d + mu * v_new if cfg.nesterov else v_new
    return (p.float() + eta * step_dir).to(p.dtype), v_new


def stack_delta(rows: Sequence[torch.Tensor],
                anchor: torch.Tensor) -> torch.Tensor:
    """(K, ...) f32 deltas ``rows[i] - anchor`` of one leaf."""
    out = torch.empty((len(rows),) + tuple(anchor.shape),
                      dtype=torch.float32, device=anchor.device)
    a = anchor.float()
    for i, r in enumerate(rows):
        torch.sub(r.float(), a, out=out[i])
    return out


@torch.no_grad()
def outer_sync(anchor: Flat, rows: Dict[str, List[torch.Tensor]], v: Flat,
               cfg: DiLoCoConfig, residual: Optional[Flat] = None, *,
               kind: str = "delta", fragment: int = -1,
               contrib: Optional[Sequence[bool]] = None,
               replicate_fn: Optional[Callable] = None) -> None:
    """One outer round over the leaves (or fragment slices) named by
    ``anchor``: ``rows[k]`` are the K workers' (or snapshots') tensors of
    leaf k, ``v[k]`` its momentum, ``residual[k]`` its (K, ...) error
    feedback carry.  Writes the new anchor, momentum and residual IN
    PLACE into those tensors (views of a larger leaf are fine).

    ``contrib`` (a quorum round's (K,) mask) names the rows that ship:
    only they are encoded and averaged, and only their residual rows are
    written, so a non-contributor's carry keeps its bits.  Each row is
    encoded on its own (per-worker scales), so a contributor's codes are
    those of an all-row exchange.

    With ``replicate_fn`` (a process mesh) ``rows`` and ``residual`` hold
    this rank's worker rows only; the transport gathers every worker's
    encoded rows, and the anchor and momentum come out as the one-process
    round's.  In a quorum round only the contributors' rows cross (one
    broadcast from each, ``Transport.ship(sources=)``): a rank encodes
    its row either way, and one counted out keeps its residual."""
    sub = (None if contrib is None or all(contrib) else
           [i for i, keep in enumerate(contrib) if keep])
    # across ranks every rank encodes its own rows and the contributors'
    # cross; on one device only the contributors' rows are stacked
    across = sub is not None and ranked(replicate_fn)
    # drift-aware weights need every leaf's delta at once; otherwise one
    # leaf at a time, so no (K, ...) stack of the whole model is held
    groups = [list(anchor)] if cfg.drift_aware else [[k] for k in anchor]
    for group in groups:
        if sub is None or across:
            delta = {k: stack_delta(rows[k], anchor[k]) for k in group}
            res = (None if residual is None else
                   {k: residual[k] for k in group})
        else:
            delta = {k: stack_delta([rows[k][i] for i in sub], anchor[k])
                     for k in group}
            idx = torch.tensor(sub, dtype=torch.long,
                               device=anchor[group[0]].device)
            res = (None if residual is None else
                   {k: residual[k].index_select(0, idx) for k in group})
        avg, new_res = exchange_and_average(
            delta, cfg, res, kind=kind, fragment=fragment,
            replicate_fn=replicate_fn, sources=sub if across else None)
        del delta
        for k in group:
            p, vv = update_leaf(anchor[k], v[k], avg[k], cfg)
            anchor[k].copy_(p)
            v[k].copy_(vv)
            if residual is None:
                continue
            if sub is None:
                residual[k].copy_(new_res[k])
            elif across:
                for j, w in enumerate(replicate_fn.rows):
                    if contrib[w]:
                        residual[k][j].copy_(new_res[k][j])
            else:
                for j, i in enumerate(sub):
                    residual[k][i].copy_(new_res[k][j])
