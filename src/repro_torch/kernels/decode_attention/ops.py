"""Decode attention wrappers: the hand-written CUDA kernels
(``csrc/paged_attention.cu``, ``csrc/ring_attention.cu``) for CUDA
tensors, the plain versions (``ref.py``) for CPU tensors.

Shapes (see ``ref.py``): q (S, KV, G, D) for decode, (S, T, KV, G, D) for
verify, float32 or bfloat16; pools (NB, bs, KV, D) in float32 or bfloat16
(read in q's dtype), or, for the ``*_dequant`` variants, an int8 /
float8_e4m3fn / float8_e5m2 payload with (NB, bs, KV) float32 scales;
block tables (S, MB) and positions (S,) int32.  All contiguous, one
device.  ``window`` > 0 limits attention to the last ``window``
positions; ``fp8=True`` runs QK^T on per-row fp8_e4m3 tiles
(``ModelConfig.fp8_matmul``).

``decode_attention`` is the ring-buffer decode of the static serving
path: q (B, KV, G, D), a cache k / v (B, KV, S, D) in q's dtype, slot
positions pos (B, S) and query positions q_pos (B,) int32.

The kernels split each row's keys into chunks of ``CHUNK_KEYS`` key
positions, one CTA each, and merge the chunks' partial softmax states in
a second kernel (``csrc/split_combine.cuh``).  The chunk count comes from
the shapes alone (:func:`split_chunks`, :func:`ring_chunks`): a wrapper
reads nothing back from the card.  The partials go to f32 scratch from
``torch.empty``.

Launch counts, one per call (a call may run the combine kernel after the
split kernel): ``paged_decode`` / ``paged_verify`` (plain pools),
``paged_decode_fp8`` / ``paged_verify_fp8`` (fp8 QK^T),
``paged_decode_dequant`` / ``paged_verify_dequant`` (quantized pools),
``ring_decode`` (the ring cache)."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention.ref import (
    decode_attention_plain, paged_decode_attention_dequant_plain,
    paged_decode_attention_plain, paged_verify_attention_dequant_plain,
    paged_verify_attention_plain)

# Key positions per CTA: the same for decode and verify, every pool type
# and the fp8 QK^T, so that verify row t stays decode at start + t, bit
# for bit.  Picked by measurement on an H100 (PERF.md).
CHUNK_KEYS = 64

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # q_dtype, pool_dtype, fp8, q, k_pool, v_pool, k_scale, v_scale, table,
    # q_pos, out, part_m, part_l, part_acc, S, KV, G, D, NB, bs, MB, window,
    # chunk_blocks, stream
    "repro_paged_decode": (_I,) * 3 + (_P,) * 11 + (_I,) * 9 + (_P,),
    # ... table, start_pos, n_tokens, out, part_m, part_l, part_acc, S, T,
    # KV, G, D, NB, bs, MB, window, chunk_blocks, stream
    "repro_paged_verify": (_I,) * 3 + (_P,) * 12 + (_I,) * 10 + (_P,),
}
_RING_SIGNATURES = {
    # dtype, q, k, v, pos, q_pos, out, part_m, part_l, part_acc, B, KV, G,
    # S, D, window, chunk, stream
    "repro_ring_decode": (_I,) + (_P,) * 9 + (_I,) * 7 + (_P,),
}
_Q_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_POOL_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2,
                torch.float8_e4m3fn: 3, torch.float8_e5m2: 4}
_PLAIN_POOLS = (torch.float32, torch.bfloat16)


def split_chunks(MB: int, bs: int) -> tuple:
    """(blocks per chunk, chunks) of a paged call over block tables (S, MB)
    of bs-key blocks: ``CHUNK_KEYS`` positions a chunk, in whole blocks."""
    cb = max(1, CHUNK_KEYS // bs)
    return cb, max(1, -(-MB // cb))


def ring_chunks(S: int) -> int:
    """Chunks of ``CHUNK_KEYS`` slots over a ring of S slots."""
    return -(-S // CHUNK_KEYS)


def _scratch(rows: int, nc: int, D: int, device) -> tuple:
    """(tensor, part_m, part_l, part_acc pointers) of the f32 partials of
    ``rows`` rows over ``nc`` chunks; no scratch for one chunk."""
    if nc == 1:
        return None, None, None, None
    buf = torch.empty(rows * nc * (D + 2), dtype=torch.float32,
                      device=device)
    acc = buf.data_ptr()
    m = acc + rows * nc * D * 4
    return buf, m, m + rows * nc * 4, acc


def _check(q, k_pool, v_pool, scales, block_tables, *index_vectors):
    if q.device.type != "cuda":
        raise ValueError(f"paged attention takes CPU or CUDA tensors, got "
                         f"{q.device}")
    if q.dtype not in _Q_DTYPES:
        raise TypeError(f"paged attention kernel takes float32 or bfloat16 "
                        f"queries, got {q.dtype}")
    if k_pool.dim() != 4 or k_pool.shape != v_pool.shape:
        raise ValueError("k_pool/v_pool must both be (NB, bs, KV, D)")
    if k_pool.dtype != v_pool.dtype:
        raise TypeError("k_pool and v_pool must share one dtype")
    quantized = scales is not None
    allowed = (tuple(_POOL_DTYPES)[2:] if quantized else _PLAIN_POOLS)
    if k_pool.dtype not in allowed:
        raise TypeError(f"pool dtype {k_pool.dtype}: the "
                        f"{'dequant' if quantized else 'plain-pool'} kernel "
                        f"takes {[str(d) for d in allowed]}")
    if (k_pool.shape[2], k_pool.shape[3]) != (q.shape[-3], q.shape[-1]):
        raise ValueError(f"pool (KV, D) {tuple(k_pool.shape[2:])} does not "
                         f"match q {tuple(q.shape)}")
    if q.shape[-1] % 4 or q.shape[-1] > 512:
        raise ValueError(f"paged attention kernel takes a head dim that is "
                         f"a multiple of 4 up to 512, got {q.shape[-1]}")
    for sc in scales or ():
        if sc.dtype != torch.float32 or sc.shape != k_pool.shape[:3]:
            raise ValueError("k_scale/v_scale must be float32 (NB, bs, KV)")
    S = q.shape[0]
    if block_tables.dim() != 2 or block_tables.shape[0] != S:
        raise ValueError("block_tables must be (S, MB)")
    for t in (block_tables,) + index_vectors:
        if t.dtype != torch.int32:
            raise TypeError("block tables and positions must be int32")
    for t in index_vectors:
        if tuple(t.shape) != (S,):
            raise ValueError(f"per-slot vectors must be ({S},)")
    for t in (q, k_pool, v_pool, block_tables) + tuple(scales or ()) \
            + index_vectors:
        if t.device != q.device:
            raise ValueError("paged attention operands must share one device")
        if not t.is_contiguous():
            raise ValueError("paged attention kernel takes contiguous tensors")


def _launch(entry: str, name: str, q, k_pool, v_pool, scales, block_tables,
            index_vectors, fp8: bool, window: int) -> torch.Tensor:
    """Check, launch one kernel and count it under ``name``."""
    _check(q, k_pool, v_pool, scales, block_tables, *index_vectors)
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    S, MB = block_tables.shape
    NB, bs, KV, D = k_pool.shape
    T = q.shape[1] if q.dim() == 5 else None
    G = q.shape[-2]
    cb, nc = split_chunks(MB, bs)
    # buf holds the scratch until the launch is queued; the caching
    # allocator orders its reuse after the kernels on this stream
    buf, *part = _scratch(q.numel() // D, nc, D, q.device)
    k_sc, v_sc = (s.data_ptr() for s in scales) if scales else (None, None)
    lib = _build.load("paged_attention", _SIGNATURES)
    with torch.cuda.device(q.device):
        rc = getattr(lib, entry)(
            _Q_DTYPES[q.dtype], _POOL_DTYPES[k_pool.dtype], int(fp8),
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), k_sc, v_sc,
            block_tables.data_ptr(), *(t.data_ptr() for t in index_vectors),
            out.data_ptr(), *part, S, *((T,) if T is not None else ()), KV,
            G, D, NB, bs, MB, int(window), cb,
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, lib, name)
    _build.launches[name] += 1
    return out


def paged_decode_attention(q, k_pool, v_pool, block_tables, q_pos, *,
                           window: int = 0, fp8: bool = False) -> torch.Tensor:
    """One query per slot at ``q_pos`` (-1 = inactive slot)."""
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, k_pool, v_pool, block_tables,
                                            q_pos, window, fp8)
    if q.dim() != 4:
        raise ValueError("q must be (S, KV, G, D)")
    return _launch("repro_paged_decode",
                   "paged_decode_fp8" if fp8 else "paged_decode", q, k_pool,
                   v_pool, None, block_tables, (q_pos,), fp8, window)


def paged_verify_attention(q, k_pool, v_pool, block_tables, start_pos,
                           n_tokens, *, window: int = 0,
                           fp8: bool = False) -> torch.Tensor:
    """T queries per slot at ``start_pos + t`` for ``t < n_tokens`` (the
    other rows are padding; ``start_pos`` -1 = inactive slot)."""
    if q.device.type == "cpu":
        return paged_verify_attention_plain(q, k_pool, v_pool, block_tables,
                                            start_pos, n_tokens, window, fp8)
    if q.dim() != 5:
        raise ValueError("q must be (S, T, KV, G, D)")
    return _launch("repro_paged_verify",
                   "paged_verify_fp8" if fp8 else "paged_verify", q, k_pool,
                   v_pool, None, block_tables, (start_pos, n_tokens), fp8,
                   window)


def paged_decode_attention_dequant(q, k_pool, v_pool, k_scale, v_scale,
                                   block_tables, q_pos, *,
                                   window: int = 0) -> torch.Tensor:
    """:func:`paged_decode_attention` over a quantized pool, dequantized
    on load."""
    if q.device.type == "cpu":
        return paged_decode_attention_dequant_plain(
            q, k_pool, v_pool, k_scale, v_scale, block_tables, q_pos, window)
    if q.dim() != 4:
        raise ValueError("q must be (S, KV, G, D)")
    return _launch("repro_paged_decode", "paged_decode_dequant", q, k_pool,
                   v_pool, (k_scale, v_scale), block_tables, (q_pos,), False,
                   window)


def paged_verify_attention_dequant(q, k_pool, v_pool, k_scale, v_scale,
                                   block_tables, start_pos, n_tokens, *,
                                   window: int = 0) -> torch.Tensor:
    """:func:`paged_verify_attention` over a quantized pool, dequantized
    on load."""
    if q.device.type == "cpu":
        return paged_verify_attention_dequant_plain(
            q, k_pool, v_pool, k_scale, v_scale, block_tables, start_pos,
            n_tokens, window)
    if q.dim() != 5:
        raise ValueError("q must be (S, T, KV, G, D)")
    return _launch("repro_paged_verify", "paged_verify_dequant", q, k_pool,
                   v_pool, (k_scale, v_scale), block_tables,
                   (start_pos, n_tokens), False, window)


def decode_attention(q, k, v, pos, q_pos, *, window: int = 0) -> torch.Tensor:
    """One query token per row against a ring-buffer cache; see
    ``decode_attention_plain`` for the gates."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, pos, q_pos, window)
    if q.device.type != "cuda":
        raise ValueError(f"decode attention takes CPU or CUDA tensors, got "
                         f"{q.device}")
    if q.dtype not in _Q_DTYPES:
        raise TypeError(f"ring decode kernel takes float32 or bfloat16, got "
                        f"{q.dtype}")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError("q must be (B, KV, G, D) and k, v (B, KV, S, D)")
    B, KV, G, D = q.shape
    S = k.shape[2]
    if (k.shape != v.shape or tuple(k.shape) != (B, KV, S, D)
            or tuple(pos.shape) != (B, S) or tuple(q_pos.shape) != (B,)):
        raise ValueError(f"cache {tuple(k.shape)} / pos {tuple(pos.shape)} "
                         f"/ q_pos {tuple(q_pos.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("the ring cache must be in q's dtype")
    if pos.dtype != torch.int32 or q_pos.dtype != torch.int32:
        raise TypeError("pos and q_pos must be int32")
    if D % 4 or D > 512:
        raise ValueError(f"ring decode kernel takes a head dim that is a "
                         f"multiple of 4 up to 512, got {D}")
    for t in (q, k, v, pos, q_pos):
        if t.device != q.device:
            raise ValueError("decode attention operands must share one "
                             "device")
        if not t.is_contiguous():
            raise ValueError("ring decode kernel takes contiguous tensors")
    out = torch.empty_like(q)
    buf, *part = _scratch(B * KV * G, ring_chunks(S), D, q.device)
    lib = _build.load("ring_attention", _RING_SIGNATURES)
    with torch.cuda.device(q.device):
        rc = lib.repro_ring_decode(
            _Q_DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            pos.data_ptr(), q_pos.data_ptr(), out.data_ptr(), *part, B, KV,
            G, S, D, int(window), CHUNK_KEYS,
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, lib, "ring_decode")
    _build.launches["ring_decode"] += 1
    return out
