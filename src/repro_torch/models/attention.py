"""Grouped-query attention: the training path (``attention``, through the
flash attention kernel) and the serving path against a paged KV pool.

Training: the JAX package picks one of three jnp score paths per call
(``_direct``, ``_blocked``, ``_banded``); all three compute causal softmax
attention with an optional window, so here all map onto the one flash
function (``repro_torch.kernels.flash_attention``), whose backward is a
kernel too.  Nothing of size (B, H, S, S) is kept for autograd.

Serving: GQA is computed grouped: queries are shaped (S, T, KV, G, hd),
so KV heads are never repeated.  The fresh K/V of every live token are
written into the pool IN PLACE before the attention reads it (the JAX package returns
a new pool; here the caller's pool tensors are updated), then the paged
kernels (``repro_torch.kernels.decode_attention``) read it through the
block table: the decode kernel for T = 1 token per slot, the verify kernel
for T > 1.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.decode_attention import (paged_decode_attention as
                                                  paged_decode_kernel,
                                                  paged_verify_attention as
                                                  paged_verify_kernel)
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.layers import apply_rope, cast, rope_cos_sin


class PagedInputs(NamedTuple):
    """Per-forward facts every layer shares, derived once from the step's
    positions (S, T) and block table (S, MB)."""
    cos: torch.Tensor        # (S, T, 1, hd/2) rotary tables at max(pos, 0)
    sin: torch.Tensor
    rows: torch.Tensor       # (n,) int64: flat (S*T) rows whose K/V are kept
    dest: torch.Tensor       # (n,) int64: their flat pool rows blk*bs + off
    q_pos: torch.Tensor      # (S,) int32: position of token 0, −1 inactive
    n_tok: torch.Tensor      # (S,) int32: live tokens per slot


def scatter_plan(positions: np.ndarray, block_table: np.ndarray,
                 block_size: int) -> np.ndarray:
    """Which fresh K/V rows a forward writes, and where, worked out on the
    host from numpy ``positions`` (S, T) and ``block_table`` (S, MB).

    Returns (2, n) int64: the flat (S*T) rows whose K/V are kept and their
    flat pool rows ``blk*bs + off``.  A token is kept iff it is live and
    its logical block is mapped (and inside the table); everything else is
    dropped, as the JAX package's out-of-bounds scatter drops it."""
    MB = block_table.shape[1]
    posc = np.maximum(positions, 0)
    col = posc // block_size
    blk = np.take_along_axis(block_table, np.minimum(col, MB - 1), axis=1)
    keep = ((positions >= 0) & (col < MB) & (blk >= 0)).reshape(-1)
    rows = np.nonzero(keep)[0]
    dest = (blk.astype(np.int64) * block_size
            + posc % block_size).reshape(-1)[rows]
    return np.stack([rows.astype(np.int64), dest])


def paged_inputs(positions: torch.Tensor, block_table: torch.Tensor,
                 cfg: ModelConfig, block_size: int,
                 scatter: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                 ) -> PagedInputs:
    """positions: (S, T) int32, −1 for a padding token or inactive slot;
    live positions of a slot must be a contiguous prefix of its row.

    ``scatter``: the (rows, dest) int64 tensors of :func:`scatter_plan`,
    computed by a caller that holds the positions and tables on the host
    (the engine does).  Without it the kept rows are selected here, with
    the same rule, which reads one count back from the device."""
    MB = block_table.shape[1]
    active = positions >= 0
    posc = positions.clamp(min=0)
    if scatter is None:
        col = torch.div(posc, block_size, rounding_mode="floor")
        blk = torch.gather(block_table, 1, col.clamp(max=MB - 1).long())
        keep = (active & (col < MB) & (blk >= 0)).reshape(-1)
        flat = (blk.long() * block_size + posc % block_size).reshape(-1)
        rows = torch.nonzero(keep).squeeze(1)
        scatter = (rows, flat[rows])
    cos, sin = rope_cos_sin(posc, cfg.resolved_head_dim(), cfg.rope_theta)
    q_pos = torch.where(active[:, 0], positions[:, 0],
                        torch.full_like(positions[:, 0], -1))
    n_tok = active.sum(dim=1, dtype=torch.int32)
    return PagedInputs(cos, sin, scatter[0], scatter[1], q_pos.contiguous(),
                       n_tok)


def project_qkv(p, x: torch.Tensor, cfg: ModelConfig):
    """x: (S, T, d) -> q (S, T, KV, G, hd), k/v (S, T, KV, hd) (for
    training, (B, S, d) in, the same shapes with B, S)."""
    dt = x.dtype
    hd = cfg.resolved_head_dim()
    q = x @ cast(p["wq"], dt)
    k = x @ cast(p["wk"], dt)
    v = x @ cast(p["wv"], dt)
    if "bq" in p:
        q = q + cast(p["bq"], dt)
        k = k + cast(p["bk"], dt)
        v = v + cast(p["bv"], dt)
    S, T = x.shape[:2]
    KV = cfg.num_kv_heads
    return (q.reshape(S, T, KV, cfg.num_heads // KV, hd),
            k.reshape(S, T, KV, hd), v.reshape(S, T, KV, hd))


def attention(p, x: torch.Tensor, cfg: ModelConfig, *,
              positions: torch.Tensor,
              window: Optional[int] = None) -> torch.Tensor:
    """Training / prefill self-attention over a full causal sequence.
    x: (B, S, d); positions: (S,) — the JAX package's ``attention`` with
    ``memory`` None.  Returns y (B, S, d)."""
    B, S = x.shape[:2]
    H, hd = cfg.num_heads, cfg.resolved_head_dim()
    q, k, v = project_qkv(p, x, cfg)
    cos, sin = rope_cos_sin(positions, hd, cfg.rope_theta)
    q = apply_rope(q.reshape(B, S, H, hd), cos, sin)
    k = apply_rope(k, cos, sin)
    out = flash_attention(q, k, v.contiguous(), causal=True,
                          window=window or None)
    return out.reshape(B, S, H * hd) @ cast(p["wo"], x.dtype)


def paged_decode_attention(p, x: torch.Tensor, cfg: ModelConfig,
                           k_pool: torch.Tensor, v_pool: torch.Tensor,
                           inputs: PagedInputs, block_table: torch.Tensor,
                           window: Optional[int] = None) -> torch.Tensor:
    """Decode / verify attention for T fresh tokens per slot.

    x: (S, T, d); k_pool/v_pool: (NB, bs, KV, hd) in x's dtype, updated in
    place with the fresh K/V; block_table: (S, MB) int32.  Returns
    y (S, T, d); rows of inactive slots and padding tokens are garbage the
    caller ignores."""
    S, T = x.shape[:2]
    hd = cfg.resolved_head_dim()
    KV = cfg.num_kv_heads
    if k_pool.dtype != x.dtype:
        raise NotImplementedError(
            f"a {k_pool.dtype} KV pool under {x.dtype} compute is not "
            f"ported; the pool must be in the compute dtype")
    q, k_new, v_new = project_qkv(p, x, cfg)
    q = apply_rope(q.reshape(S, T, cfg.num_heads, hd), inputs.cos,
                   inputs.sin).reshape(q.shape)
    k_new = apply_rope(k_new, inputs.cos, inputs.sin)

    NB, bs = k_pool.shape[:2]
    k_pool.view(NB * bs, KV, hd).index_copy_(
        0, inputs.dest, k_new.reshape(S * T, KV, hd).index_select(
            0, inputs.rows))
    v_pool.view(NB * bs, KV, hd).index_copy_(
        0, inputs.dest, v_new.reshape(S * T, KV, hd).index_select(
            0, inputs.rows))

    w = int(window or 0)
    if T == 1:
        out = paged_decode_kernel(q[:, 0].contiguous(), k_pool, v_pool,
                                  block_table, inputs.q_pos,
                                  window=w)[:, None]
    else:
        out = paged_verify_kernel(q.contiguous(), k_pool, v_pool,
                                  block_table, inputs.q_pos, inputs.n_tok,
                                  window=w)
    out = out.reshape(S, T, cfg.num_heads * hd)
    return out @ cast(p["wo"], x.dtype)
