"""Mixture-of-Experts layer — the port of the JAX package's
``repro.models.moe.apply_moe``: a top-k router in f32, a Switch-style
load-balance loss, capacity-based sort dispatch per sequence, a batched
SwiGLU expert MLP and a gate-weighted combine, plus optional shared
experts.

Capacity is per sequence per call: for x (B, S, d) each row's tokens go
to (E, C) buffers with ``C = max(ceil(S·K/E · moe_capacity_factor), K)``;
the (token, choice) entries are stably sorted by expert, ranked within
their expert, and those ranked past C are dropped (they contribute
nothing).  A serving step's rows are its slots and S its token columns,
so decode (T 1), verify (T > 1) and the full forward each pick their own
C, as in the reference.

Determinism.  Moving rows between the token and the buffer layout is a
gather both ways (``_Dispatch`` and ``_Combine``, each the other's
adjoint): every buffer slot holds at most one entry and every token
exactly K, so the backward of either gathers too and the K
contributions of a token are summed in a fixed order.  No scatter-add
(atomics on CUDA) is on the forward or the backward path, so a second
call gives the same bits and remat on == off holds bit for bit.

The expert products are ``torch.bmm`` over the (E, B·C, d) buffers (the
reference computes them with ``einsum`` outside any kernel); the router,
the dispatch and the combine are plain tensor code as in the reference.
The router and the shared experts take the serving forward's matrix
product (``mm``); the expert products do not run per token column, so
on a quantized KV pool a verify forward is not held to decode's bits.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import cast


def moe_param_shapes(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    """Leaf name -> shape of one layer's MoE parameters."""
    d, f, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    shapes = {"router": (d, E), "w_gate": (E, d, f), "w_up": (E, d, f),
              "w_down": (E, f, d)}
    if cfg.num_shared_experts:
        fs = f * cfg.num_shared_experts
        shapes.update({"shared_gate": (d, fs), "shared_up": (d, fs),
                       "shared_down": (fs, d)})
    return shapes


def capacity(cfg: ModelConfig, S: int) -> int:
    """Buffer rows per expert for a sequence of S tokens."""
    E, K = cfg.num_experts, cfg.num_experts_per_tok
    return max(int(math.ceil(S * K / E * cfg.moe_capacity_factor)), K)


def _pad_row(t: torch.Tensor) -> torch.Tensor:
    """(B, n, d) -> (B, n + 1, d) with a zero row at n."""
    return torch.cat([t, t.new_zeros(t.shape[0], 1, t.shape[2])], dim=1)


def _take(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """src (B, n, d) with a zero row appended, gathered at idx (B, m)
    (index n = the zero row) -> (B, m, d)."""
    return torch.gather(_pad_row(src), 1,
                        idx[..., None].expand(-1, -1, src.shape[2]))


class _Dispatch(torch.autograd.Function):
    """x (B, S, d) -> buffers (B, E·C, d): slot j takes token
    ``slot_tok[:, j]`` (S = empty).  Backward: token s sums the gradient
    of its K slots ``entry_slot[:, s·K + k]`` (E·C = dropped), k in
    order."""

    @staticmethod
    def forward(ctx, x, slot_tok, entry_slot, K):
        ctx.save_for_backward(entry_slot)
        ctx.K = K
        return _take(x, slot_tok)

    @staticmethod
    def backward(ctx, g):
        (entry_slot,) = ctx.saved_tensors
        B, SK = entry_slot.shape
        parts = _take(g, entry_slot).reshape(B, SK // ctx.K, ctx.K, -1)
        gx = parts[:, :, 0]
        for k in range(1, ctx.K):
            gx = gx + parts[:, :, k]
        return gx, None, None, None


class _Combine(torch.autograd.Function):
    """buffers (B, E·C, d) -> entries (B, S·K, d): entry e reads slot
    ``entry_slot[:, e]`` (E·C = dropped: zeros).  Backward: slot j takes
    the gradient of its one entry ``slot_entry[:, j]`` (S·K = empty)."""

    @staticmethod
    def forward(ctx, y, entry_slot, slot_entry):
        ctx.save_for_backward(slot_entry)
        return _take(y, entry_slot)

    @staticmethod
    def backward(ctx, g):
        (slot_entry,) = ctx.saved_tensors
        return _take(g, slot_entry), None, None


def _route(x32: torch.Tensor, router: torch.Tensor, cfg: ModelConfig, mm):
    """Router probabilities (B, S, E), the renormalised top-K gates and
    experts (B, S, K), and the per-row Switch loss (B,)."""
    E, K = cfg.num_experts, cfg.num_experts_per_tok
    probs = torch.softmax(mm(x32, router.float()), dim=-1)
    gate, expert = torch.topk(probs, K, dim=-1)
    gate = gate / gate.sum(dim=-1, keepdim=True)
    me = probs.mean(dim=1)
    ce = F.one_hot(expert, E).float().sum(dim=2).mean(dim=1)
    return gate, expert, E * (me * ce).sum(dim=-1)


def _plan(expert: torch.Tensor, E: int, C: int):
    """The dispatch plan of experts (B, S, K): per entry (s·K + k) its
    buffer slot ``e·C + rank`` or E·C when dropped, and per slot its
    entry or S·K when empty.  Entries are ranked within their expert in
    the stable sort order of the flattened entries."""
    B, S, K = expert.shape
    flat = expert.reshape(B, S * K)
    sorted_e, order = torch.sort(flat, dim=1, stable=True)
    counts = F.one_hot(flat, E).sum(dim=1)                     # (B, E)
    starts = torch.cumsum(counts, dim=1) - counts
    ar = torch.arange(S * K, device=flat.device)[None, :]
    rank = ar - torch.gather(starts, 1, sorted_e)
    keep = rank < C
    dest = torch.where(keep, sorted_e * C + rank,
                       torch.full_like(rank, E * C))
    entry_slot = torch.empty_like(dest).scatter_(1, order, dest)
    slot_entry = torch.full((B, E * C + 1), S * K, dtype=order.dtype,
                            device=flat.device)
    # dropped entries all land on the spare column E·C, which is cut off
    slot_entry.scatter_(1, dest, order)
    return entry_slot, slot_entry[:, :E * C].contiguous(), keep


def dropped_entries(p, x: torch.Tensor, cfg: ModelConfig,
                    mm=torch.matmul) -> torch.Tensor:
    """How many of the B·S·K (token, choice) entries ``apply_moe(p, x,
    cfg, mm)`` drops (a device scalar): the same router and plan."""
    _, expert, _ = _route(x.float(), p["router"], cfg, mm)
    keep = _plan(expert, cfg.num_experts, capacity(cfg, x.shape[1]))[2]
    return (~keep).sum()


def apply_moe(p, x: torch.Tensor, cfg: ModelConfig,
              mm=torch.matmul) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (y (B, S, d), aux), aux the Switch loss
    ``E·Σ me·ce`` of each row, averaged over rows.  ``mm``: the router's
    and shared experts' matrix product (``serving_matmul`` when
    serving)."""
    B, S, d = x.shape
    E, K = cfg.num_experts, cfg.num_experts_per_tok
    C = capacity(cfg, S)
    dt = x.dtype
    gate, expert, aux = _route(x.float(), p["router"], cfg, mm)
    entry_slot, slot_entry, _ = _plan(expert, E, C)
    slot_tok = torch.where(slot_entry < S * K,
                           torch.div(slot_entry, K, rounding_mode="floor"),
                           torch.full_like(slot_entry, S))
    xe = _Dispatch.apply(x, slot_tok, entry_slot, K)           # (B, EC, d)
    xe = xe.reshape(B, E, C, d).transpose(0, 1).reshape(E, B * C, d)
    h = F.silu(torch.bmm(xe, cast(p["w_gate"], dt))) * torch.bmm(
        xe, cast(p["w_up"], dt))
    ye = torch.bmm(h, cast(p["w_down"], dt))                   # (E, BC, d)
    ye = ye.reshape(E, B, C, d).transpose(0, 1).reshape(B, E * C, d)
    contrib = _Combine.apply(ye, entry_slot, slot_entry)
    w = (gate.reshape(B, S * K) * (entry_slot < E * C))[..., None].to(dt)
    contrib = (contrib * w).reshape(B, S, K, d)
    out = contrib[:, :, 0]
    for k in range(1, K):
        out = out + contrib[:, :, k]
    if cfg.num_shared_experts:
        hs = F.silu(mm(x, cast(p["shared_gate"], dt))) * mm(
            x, cast(p["shared_up"], dt))
        out = out + mm(hs, cast(p["shared_down"], dt))
    return out, aux.mean()
