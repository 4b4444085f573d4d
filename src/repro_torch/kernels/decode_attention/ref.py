"""Plain PyTorch versions of the paged attention kernels: the CPU path of
the wrappers in ``ops.py`` and the yardstick the CUDA kernels are held to.

An einsum over the gathered blocks, the same math as the JAX package's
oracles (``src/repro/kernels/decode_attention/ref.py``): f32 scores and
softmax, masked lanes set to the finite -1e30, output in q's dtype.  A
row with no attendable key (inactive slot, padding token) comes back as
garbage the caller ignores."""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def _gather(pool: torch.Tensor, block_tables: torch.Tensor) -> torch.Tensor:
    """(NB, bs, KV, D) pool -> (S, MB*bs, KV, D) f32, through the table
    with unmapped (-1) entries read from block 0 (they are masked)."""
    S, MB = block_tables.shape
    bs, KV, D = pool.shape[1:]
    safe = block_tables.clamp(min=0).long()
    return pool[safe].reshape(S, MB * bs, KV, D).float()


def _key_mask(block_tables: torch.Tensor, bs: int) -> tuple:
    """(logical key positions (L,), mapped (S, L)) for L = MB*bs lanes."""
    MB = block_tables.shape[1]
    k_pos = torch.arange(MB * bs, device=block_tables.device)
    mapped = (block_tables >= 0).repeat_interleave(bs, dim=1)
    return k_pos, mapped


def paged_decode_attention_plain(q, k_pool, v_pool, block_tables, q_pos,
                                 window: int = 0) -> torch.Tensor:
    """q: (S, KV, G, D); k_pool/v_pool: (NB, bs, KV, D); block_tables:
    (S, MB) int32 (-1 = unmapped); q_pos: (S,) int32 (-1 = inactive).
    Returns (S, KV, G, D)."""
    D = q.shape[-1]
    bs = k_pool.shape[1]
    k = _gather(k_pool, block_tables)
    v = _gather(v_pool, block_tables)
    k_pos, mapped = _key_mask(block_tables, bs)
    qp = q_pos.long()[:, None]
    ok = (k_pos[None, :] <= qp) & mapped
    if window > 0:
        ok &= (qp - k_pos[None, :]) < window
    s = torch.einsum("bhgd,bshd->bhgs", q.float(), k) / math.sqrt(D)
    s = s.masked_fill(~ok[:, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhgs,bshd->bhgd", p, v).to(q.dtype)


def paged_verify_attention_plain(q, k_pool, v_pool, block_tables, start_pos,
                                 n_tokens, window: int = 0) -> torch.Tensor:
    """q: (S, T, KV, G, D); query token t of slot s sits at position
    ``start_pos[s] + t`` and is live iff ``start_pos[s] >= 0`` and
    ``t < n_tokens[s]``.  Returns (S, T, KV, G, D)."""
    T, D = q.shape[1], q.shape[-1]
    bs = k_pool.shape[1]
    k = _gather(k_pool, block_tables)
    v = _gather(v_pool, block_tables)
    k_pos, mapped = _key_mask(block_tables, bs)
    t = torch.arange(T, device=q.device)
    qp = start_pos.long()[:, None] + t[None, :]                  # (S, T)
    valid = (start_pos[:, None] >= 0) & (t[None, :] < n_tokens[:, None])
    ok = ((k_pos[None, None, :] <= qp[:, :, None]) & valid[:, :, None]
          & mapped[:, None, :])
    if window > 0:
        ok &= (qp[:, :, None] - k_pos[None, None, :]) < window
    s = torch.einsum("bthgd,bshd->bhgts", q.float(), k) / math.sqrt(D)
    s = s.masked_fill(~ok[:, None, None, :, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhgts,bshd->bthgd", p, v).to(q.dtype)
