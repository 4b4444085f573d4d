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

``outer_sync`` runs the round one leaf at a time: it stacks one leaf's K
worker deltas, encodes, ships, decodes and averages them, and applies the
outer update to that leaf before it touches the next, so no (K, ...)
stack of the whole model is held.  Leaves are independent, so this gives
the reference's whole-tree result bit for bit.  Drift-aware averaging
weighs each worker by the cosine of its WHOLE delta to the mean, which
needs every leaf first: that path decodes all leaves, then averages.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import DiLoCoConfig
from repro_torch.core.transport import (QuantizedCodec, Transport,
                                        make_codec, wire_width)
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


def make_transport(cfg: DiLoCoConfig) -> Transport:
    """The transport the config describes: the quantize kernels on CUDA
    tensors, their plain versions on CPU tensors."""
    return Transport(make_codec(cfg.delta_dtype))


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

def _tree_dot(a: Flat, b: Flat) -> torch.Tensor:
    out = None
    for k in a:
        s = torch.sum(a[k].float() * b[k].float())
        out = s if out is None else out + s
    return out


def _mean(d: torch.Tensor) -> torch.Tensor:
    """Mean over the leading worker dim, summed in worker order (for K=2
    exactly the reference's ``jnp.mean``)."""
    acc = d[0]
    for i in range(1, d.shape[0]):
        acc = acc + d[i]
    return acc / d.shape[0]


def _average(delta: Flat, cfg: DiLoCoConfig,
             live: Optional[Sequence[bool]] = None) -> Flat:
    """Decoded f32 (K, ...) stacked deltas -> averaged delta dict; with
    ``drift_aware`` each worker is weighted by softmax(4 · cos(Δ_i, Δ̄))
    over the whole dict.

    ``live`` is the quorum round's (K,) contribution mask: only its rows
    enter the mean (and the drift-aware weights, where the reference
    gives the rest -inf logits).  They are picked out before the same
    expressions run, so the masked mean IS the plain mean of the
    survivors, bit for bit, and an all-live mask is the unmasked
    average.  ``live=None`` is the unmasked average."""
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
    k_workers = next(iter(delta.values())).shape[0]
    mean_norm = torch.sqrt(_tree_dot(mean, mean)) + 1e-12
    cos = []
    for i in range(k_workers):
        di = {k: d[i] for k, d in delta.items()}
        ni = torch.sqrt(_tree_dot(di, di)) + 1e-12
        cos.append(_tree_dot(di, mean) / (ni * mean_norm))
    w = torch.softmax(4.0 * torch.stack(cos), dim=0)          # (K,)
    return {k: torch.tensordot(w, d.float(), dims=([0], [0]))
            for k, d in delta.items()}


def exchange_and_average(stacked_delta: Flat, cfg: DiLoCoConfig,
                         residual: Optional[Flat] = None,
                         kind: str = "delta", fragment: int = -1,
                         live: Optional[Sequence[bool]] = None
                         ) -> Tuple[Flat, Optional[Flat]]:
    """encode -> ship -> decode -> average; returns (averaged delta, new
    error-feedback residual or None).  ``live`` is the quorum round's
    contribution mask (``_average``)."""
    full, new_residual = make_transport(cfg).exchange(
        stacked_delta, residual, kind=kind, fragment=fragment)
    return _average(full, cfg, live=live), new_residual


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
               contrib: Optional[Sequence[bool]] = None) -> None:
    """One outer round over the leaves (or fragment slices) named by
    ``anchor``: ``rows[k]`` are the K workers' (or snapshots') tensors of
    leaf k, ``v[k]`` its momentum, ``residual[k]`` its (K, ...) error
    feedback carry.  Writes the new anchor, momentum and residual IN
    PLACE into those tensors (views of a larger leaf are fine).

    ``contrib`` (a quorum round's (K,) mask) names the rows that ship:
    only they are encoded and averaged, and only their residual rows are
    written, so a non-contributor's carry keeps its bits.  Each row is
    encoded on its own (per-worker scales), so a contributor's codes are
    those of an all-row exchange."""
    sub = (None if contrib is None or all(contrib) else
           [i for i, keep in enumerate(contrib) if keep])
    # drift-aware weights need every leaf's delta at once; otherwise one
    # leaf at a time, so no (K, ...) stack of the whole model is held
    groups = [list(anchor)] if cfg.drift_aware else [[k] for k in anchor]
    for group in groups:
        if sub is None:
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
        avg, new_res = exchange_and_average(delta, cfg, res, kind=kind,
                                            fragment=fragment)
        del delta
        for k in group:
            p, vv = update_leaf(anchor[k], v[k], avg[k], cfg)
            anchor[k].copy_(p)
            v[k].copy_(vv)
            if residual is None:
                continue
            if sub is None:
                residual[k].copy_(new_res[k])
            else:
                for j, i in enumerate(sub):
                    residual[k][i].copy_(new_res[k][j])
