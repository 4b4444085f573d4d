"""Plain PyTorch versions of the paged attention kernels and of the
ring-buffer decode kernel: the CPU path of the wrappers in ``ops.py`` and
the yardstick the CUDA kernels are held to.

An einsum over the gathered blocks, the same math as the JAX package's
oracles (``src/repro/kernels/decode_attention/ref.py``): f32 scores and
softmax, masked lanes set to the finite -1e30, output in q's dtype.  A
row with no attendable key (inactive slot, padding token) comes back as
garbage the caller ignores.

Pools are read in q's dtype, as the JAX package casts them before its
kernels: a bf16 pool under f32 queries widens exactly.  Three variants:

* plain pools (``fp8=False``);
* ``fp8=True``: the QK^T of ``ModelConfig.fp8_matmul``.  Each Q row and
  each pooled K row (over D) is quantized to fp8_e4m3 with its own amax
  scale and dequantized, as the oracle's ``_fp8_rows`` does; V and the
  PV product stay f32.  The rows stay f32 after the round trip (the
  kernels contract the upcast fp8 values in f32 and rescale);
* quantized pools (``*_dequant``): an int8 / fp8_e4m3 / fp8_e5m2 payload
  with (NB, bs, KV) f32 per-token-per-head scales, dequantized in f32
  and cast to q's dtype, then the plain math.  ``fp8_matmul`` does not
  apply to them, as in the JAX package.

``decode_attention_plain`` is the ring-buffer decode of the static serving
path, a copy of the JAX package's ``reference_decode_attention``: the
cache (B, KV, S, D) with a per-slot position array, the causal gate and
the window gate.

The ``*_split_plain`` functions mirror the CUDA kernels' split-key design
for the tests (the wrappers never call them): each row's keys cut into
chunks of ``chunk_keys`` positions (whole blocks on a paged pool), one
partial softmax state (m, l, acc) per (row, chunk) with masked keys at
exactly zero, merged in ascending chunk order (``combine_partials``).
Each row's values depend only on its own q row, keys and position limit,
so verify row t equals decode at ``start + t`` bit for bit, and decode is
verify at T = 1, as in the kernels.

Two of the mirror's parts are also plain versions the wrappers call: the
ring's partial states (``decode_attention_partials_plain``) and their
merge (``combine_partials``), the two halves of the sequence-parallel
decode (a ``kv_seq`` cache: each rank's slots' partials, gathered across
the ranks, merged once)."""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.quantize import quantize_axis

NEG_INF = -1e30
_ONE_BYTE = (torch.int8, torch.float8_e4m3fn, torch.float8_e5m2)


def _gather(pool: torch.Tensor, block_tables: torch.Tensor,
            dtype: torch.dtype,
            scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(NB, bs, KV, D) pool -> (S, MB*bs, KV, D) f32 through the table,
    unmapped (-1) entries read from block 0 (they are masked).  Values
    pass through ``dtype`` (q's); a quantized pool is first multiplied by
    its (NB, bs, KV) ``scale``."""
    S, MB = block_tables.shape
    bs, KV, D = pool.shape[1:]
    safe = block_tables.clamp(min=0).long()
    if pool.dtype in _ONE_BYTE:          # gather the bytes: no fp8 indexing
        x = pool.view(torch.uint8)[safe].view(pool.dtype).float()
    else:
        x = pool[safe].float()
    if scale is not None:
        x = x * scale[safe][..., None]
    return x.to(dtype).float().reshape(S, MB * bs, KV, D)


def _fp8_rows(x: torch.Tensor) -> torch.Tensor:
    """Each row of ``x`` (..., D) through fp8_e4m3 with its own amax
    scale and back, in f32."""
    q8, s = quantize_axis(x, axis=-1, dtype="fp8_e4m3")
    return q8.float() * s


def _key_mask(block_tables: torch.Tensor, bs: int) -> tuple:
    """(logical key positions (L,), mapped (S, L)) for L = MB*bs lanes."""
    MB = block_tables.shape[1]
    k_pos = torch.arange(MB * bs, device=block_tables.device)
    mapped = (block_tables >= 0).repeat_interleave(bs, dim=1)
    return k_pos, mapped


def _decode(q, k, v, block_tables, q_pos, bs, window, fp8):
    """q (S, KV, G, D); k/v gathered (S, L, KV, D) f32."""
    D = q.shape[-1]
    k_pos, mapped = _key_mask(block_tables, bs)
    qp = q_pos.long()[:, None]
    ok = (k_pos[None, :] <= qp) & mapped
    if window > 0:
        ok &= (qp - k_pos[None, :]) < window
    qf = q.float()
    if fp8:
        qf, k = _fp8_rows(qf), _fp8_rows(k)
    s = torch.einsum("bhgd,bshd->bhgs", qf, k) / math.sqrt(D)
    s = s.masked_fill(~ok[:, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhgs,bshd->bhgd", p, v).to(q.dtype)


def _verify(q, k, v, block_tables, start_pos, n_tokens, bs, window, fp8):
    """q (S, T, KV, G, D); k/v gathered (S, L, KV, D) f32."""
    T, D = q.shape[1], q.shape[-1]
    k_pos, mapped = _key_mask(block_tables, bs)
    t = torch.arange(T, device=q.device)
    qp = start_pos.long()[:, None] + t[None, :]                  # (S, T)
    valid = (start_pos[:, None] >= 0) & (t[None, :] < n_tokens[:, None])
    ok = ((k_pos[None, None, :] <= qp[:, :, None]) & valid[:, :, None]
          & mapped[:, None, :])
    if window > 0:
        ok &= (qp[:, :, None] - k_pos[None, None, :]) < window
    qf = q.float()
    if fp8:
        qf, k = _fp8_rows(qf), _fp8_rows(k)
    s = torch.einsum("bthgd,bshd->bhgts", qf, k) / math.sqrt(D)
    s = s.masked_fill(~ok[:, None, None, :, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhgts,bshd->bthgd", p, v).to(q.dtype)


def paged_decode_attention_plain(q, k_pool, v_pool, block_tables, q_pos,
                                 window: int = 0,
                                 fp8: bool = False) -> torch.Tensor:
    """q: (S, KV, G, D); k_pool/v_pool: (NB, bs, KV, D); block_tables:
    (S, MB) int32 (-1 = unmapped); q_pos: (S,) int32 (-1 = inactive).
    Returns (S, KV, G, D)."""
    k = _gather(k_pool, block_tables, q.dtype)
    v = _gather(v_pool, block_tables, q.dtype)
    return _decode(q, k, v, block_tables, q_pos, k_pool.shape[1], window,
                   fp8)


def paged_verify_attention_plain(q, k_pool, v_pool, block_tables, start_pos,
                                 n_tokens, window: int = 0,
                                 fp8: bool = False) -> torch.Tensor:
    """q: (S, T, KV, G, D); query token t of slot s sits at position
    ``start_pos[s] + t`` and is live iff ``start_pos[s] >= 0`` and
    ``t < n_tokens[s]``.  Returns (S, T, KV, G, D)."""
    k = _gather(k_pool, block_tables, q.dtype)
    v = _gather(v_pool, block_tables, q.dtype)
    return _verify(q, k, v, block_tables, start_pos, n_tokens,
                   k_pool.shape[1], window, fp8)


def paged_decode_attention_dequant_plain(q, k_pool, v_pool, k_scale,
                                         v_scale, block_tables, q_pos,
                                         window: int = 0) -> torch.Tensor:
    """:func:`paged_decode_attention_plain` over a quantized pool:
    payloads (NB, bs, KV, D) int8 / fp8, scales (NB, bs, KV) f32."""
    k = _gather(k_pool, block_tables, q.dtype, k_scale)
    v = _gather(v_pool, block_tables, q.dtype, v_scale)
    return _decode(q, k, v, block_tables, q_pos, k_pool.shape[1], window,
                   False)


def paged_verify_attention_dequant_plain(q, k_pool, v_pool, k_scale,
                                         v_scale, block_tables, start_pos,
                                         n_tokens,
                                         window: int = 0) -> torch.Tensor:
    """:func:`paged_verify_attention_plain` over a quantized pool."""
    k = _gather(k_pool, block_tables, q.dtype, k_scale)
    v = _gather(v_pool, block_tables, q.dtype, v_scale)
    return _verify(q, k, v, block_tables, start_pos, n_tokens,
                   k_pool.shape[1], window, False)


def decode_attention_plain(q, k, v, pos, q_pos,
                           window: int = 0) -> torch.Tensor:
    """q: (B, KV, G, D); k / v: (B, KV, S, D); pos: (B, S) int32 (-1 =
    empty slot); q_pos: (B,) int32.  A slot is attended iff pos >= 0,
    pos <= q_pos and, with ``window`` > 0, q_pos - pos < window.  Returns
    (B, KV, G, D) in q's dtype."""
    D = q.shape[-1]
    s = torch.einsum("bhgd,bhsd->bhgs", q.float(), k.float()) / math.sqrt(D)
    pos, qp = pos.long(), q_pos.long()[:, None]
    ok = (pos >= 0) & (pos <= qp)
    if window > 0:
        ok &= (qp - pos) < window
    s = s.masked_fill(~ok[:, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhgs,bhsd->bhgd", p, v.float()).to(q.dtype)


# ---------------------------------------------------------------------------
# The split-key mirror (the ring's partials and their merge are also the
# CPU path of the split ring entries)
# ---------------------------------------------------------------------------

def _exp(x: torch.Tensor) -> torch.Tensor:
    """exp in f64, rounded to f32: the same bits whichever of PyTorch's
    vector or scalar loops an element falls in."""
    return torch.exp(x.double()).float()


def _split_states(s, ok, v_t, chunk: int) -> tuple:
    """Partial softmax states of chunks of ``chunk`` keys.  s, ok (..., L)
    each row's scores and mask; v_t (..., D, L) its values, transposed
    (broadcast over rows).  Keys past L pad the last chunk, masked.
    Returns m (..., nc) (-inf where a chunk has no key), l (..., nc) and
    acc (..., nc, D).  Every reduction runs over a row's own contiguous
    last axis."""
    nc = -(-s.shape[-1] // chunk)
    pad = nc * chunk - s.shape[-1]
    s, ok, v_t = F.pad(s, (0, pad)), F.pad(ok, (0, pad)), F.pad(v_t, (0, pad))
    s = s.masked_fill(~ok, -math.inf).unflatten(-1, (nc, chunk))
    ok = ok.unflatten(-1, (nc, chunk))
    m = s.amax(-1)
    p = torch.where(ok, _exp(s - m[..., None]), 0.0).contiguous()
    vc = v_t.unflatten(-1, (nc, chunk)).transpose(-3, -2)
    acc = (p[..., None, :] * vc).contiguous().sum(-1)
    return m, p.sum(-1), acc


def combine_partials(m, l, acc) -> torch.Tensor:
    """Merge the partials of each row in ascending chunk order: chunk c
    weighs exp(m_c - M) (exactly 1 for the max's chunk), an empty chunk (m
    = -inf) weighs 0 and its l and acc are never read; acc / l in f32, and
    zeros for a row with no key."""
    M = m.amax(-1)
    L = torch.zeros_like(M)
    A = torch.zeros_like(acc[..., 0, :])
    for c in range(m.shape[-1]):
        mc = m[..., c]
        w = torch.where(mc == -math.inf, 0.0,
                        torch.where(mc == M, 1.0, _exp(mc - M)))
        on = w != 0
        L = torch.where(on, L + l[..., c] * w, L)
        A = torch.where(on[..., None], A + acc[..., c, :] * w[..., None], A)
    return torch.where((M == -math.inf)[..., None], 0.0, A / L[..., None])


def paged_verify_split_plain(q, k_pool, v_pool, block_tables, start_pos,
                             n_tokens, window: int = 0, fp8: bool = False,
                             k_scale=None, v_scale=None, *,
                             chunk_keys: int = 64) -> torch.Tensor:
    """:func:`paged_verify_attention_plain` (with ``k_scale``/``v_scale``
    its dequant variant) through the split and the combine: chunks of
    max(1, chunk_keys // bs) whole blocks.  Rows with no attendable key
    are zeros."""
    S, T, KV, G, D = q.shape
    bs, MB = k_pool.shape[1], block_tables.shape[1]
    k = _gather(k_pool, block_tables, q.dtype, k_scale)
    v = _gather(v_pool, block_tables, q.dtype, v_scale)
    k_pos, mapped = _key_mask(block_tables, bs)
    t = torch.arange(T, device=q.device)
    qp = start_pos.long()[:, None] + t[None, :]                   # (S, T)
    valid = (start_pos[:, None] >= 0) & (t[None, :] < n_tokens[:, None])
    ok = ((k_pos[None, None, :] <= qp[:, :, None]) & valid[:, :, None]
          & mapped[:, None, :])
    if window > 0:
        ok &= (qp[:, :, None] - k_pos[None, None, :]) < window
    qf = q.float()
    if fp8:
        qf, k = _fp8_rows(qf), _fp8_rows(k)
    kk = k.permute(0, 2, 1, 3)[:, None, :, None]              # (S,1,KV,1,L,D)
    s = (qf[..., None, :] * kk).contiguous().sum(-1) / math.sqrt(D)
    v_t = v.permute(0, 2, 3, 1)[:, None, :, None]             # (S,1,KV,1,D,L)
    m, l, acc = _split_states(s, ok[:, :, None, None, :], v_t,
                              max(1, chunk_keys // bs) * bs)
    return combine_partials(m, l, acc).to(q.dtype)


def paged_decode_split_plain(q, k_pool, v_pool, block_tables, q_pos,
                             window: int = 0, fp8: bool = False,
                             k_scale=None, v_scale=None, *,
                             chunk_keys: int = 64) -> torch.Tensor:
    """Decode through the split: verify at T = 1, as the kernels run it."""
    return paged_verify_split_plain(
        q[:, None], k_pool, v_pool, block_tables, q_pos,
        (q_pos >= 0).to(torch.int32), window, fp8, k_scale, v_scale,
        chunk_keys=chunk_keys)[:, 0]


def decode_attention_partials_plain(q, k, v, pos, q_pos, window: int = 0,
                                    *, chunk_keys: int = 64) -> tuple:
    """The ring decode's partial softmax states over chunks of
    ``chunk_keys`` slots (:func:`decode_attention_plain`'s gates): m, l
    (B, KV, G, nc) and acc (B, KV, G, nc, D), f32; a chunk with no live
    slot has m = -inf, l = 0 and acc = 0."""
    D = q.shape[-1]
    pos, qp = pos.long(), q_pos.long()[:, None]
    ok = (pos >= 0) & (pos <= qp)
    if window > 0:
        ok &= (qp - pos) < window
    s = (q.float()[..., None, :] * k.float()[:, :, None]).contiguous().sum(-1)
    return _split_states(s / math.sqrt(D), ok[:, None, None, :],
                         v.float().transpose(-1, -2)[:, :, None], chunk_keys)


def decode_attention_split_plain(q, k, v, pos, q_pos, window: int = 0, *,
                                 chunk_keys: int = 64) -> torch.Tensor:
    """:func:`decode_attention_plain` through the split: chunks of
    ``chunk_keys`` ring slots.  Rows with no live slot are zeros."""
    return combine_partials(*decode_attention_partials_plain(
        q, k, v, pos, q_pos, window, chunk_keys=chunk_keys)).to(q.dtype)
