"""Paged attention wrappers: the hand-written CUDA kernels
(``csrc/paged_attention.cu``) for CUDA tensors, the plain versions
(``ref.py``) for CPU tensors.

Shapes (see ``ref.py``): q (S, KV, G, D) for decode, (S, T, KV, G, D) for
verify; pools (NB, bs, KV, D) in q's dtype (float32 or bfloat16); block
tables (S, MB) and positions (S,) int32.  All contiguous, one device.
``window`` > 0 limits attention to the last ``window`` positions."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention.ref import (
    paged_decode_attention_plain, paged_verify_attention_plain)

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "repro_paged_decode": (_I, _P, _P, _P, _P, _P, _P) + (_I,) * 8 + (_P,),
    "repro_paged_verify": (_I, _P, _P, _P, _P, _P, _P, _P) + (_I,) * 9
    + (_P,),
}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check(q, k_pool, v_pool, block_tables, *index_vectors):
    if q.device.type != "cuda":
        raise ValueError(f"paged attention takes CPU or CUDA tensors, got "
                         f"{q.device}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"paged attention kernel takes float32 or bfloat16, "
                        f"got {q.dtype}")
    if k_pool.dim() != 4 or k_pool.shape != v_pool.shape:
        raise ValueError("k_pool/v_pool must both be (NB, bs, KV, D)")
    if k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise TypeError("pools must be in q's dtype")
    if (k_pool.shape[2], k_pool.shape[3]) != (q.shape[-3], q.shape[-1]):
        raise ValueError(f"pool (KV, D) {tuple(k_pool.shape[2:])} does not "
                         f"match q {tuple(q.shape)}")
    S = q.shape[0]
    if block_tables.dim() != 2 or block_tables.shape[0] != S:
        raise ValueError("block_tables must be (S, MB)")
    for t in (block_tables,) + index_vectors:
        if t.dtype != torch.int32:
            raise TypeError("block tables and positions must be int32")
    for t in index_vectors:
        if tuple(t.shape) != (S,):
            raise ValueError(f"per-slot vectors must be ({S},)")
    for t in (q, k_pool, v_pool, block_tables) + index_vectors:
        if t.device != q.device:
            raise ValueError("paged attention operands must share one device")
        if not t.is_contiguous():
            raise ValueError("paged attention kernel takes contiguous tensors")


def _lib():
    return _build.load("paged_attention", _SIGNATURES)


def paged_decode_attention(q, k_pool, v_pool, block_tables, q_pos, *,
                           window: int = 0) -> torch.Tensor:
    """One query per slot at ``q_pos`` (-1 = inactive slot)."""
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, k_pool, v_pool, block_tables,
                                            q_pos, window)
    if q.dim() != 4:
        raise ValueError("q must be (S, KV, G, D)")
    _check(q, k_pool, v_pool, block_tables, q_pos)
    S, KV, G, D = q.shape
    NB, bs = k_pool.shape[:2]
    out = torch.empty_like(q)
    if S * KV == 0:
        return out
    lib = _lib()
    with torch.cuda.device(q.device):
        rc = lib.repro_paged_decode(
            _DTYPES[q.dtype], q.data_ptr(), k_pool.data_ptr(),
            v_pool.data_ptr(), block_tables.data_ptr(), q_pos.data_ptr(),
            out.data_ptr(), S, KV, G, D, NB, bs, block_tables.shape[1],
            int(window), torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, lib, "paged_decode_attention")
    _build.launches["paged_decode"] += 1
    return out


def paged_verify_attention(q, k_pool, v_pool, block_tables, start_pos,
                           n_tokens, *, window: int = 0) -> torch.Tensor:
    """T queries per slot at ``start_pos + t`` for ``t < n_tokens`` (the
    other rows are padding; ``start_pos`` -1 = inactive slot)."""
    if q.device.type == "cpu":
        return paged_verify_attention_plain(q, k_pool, v_pool, block_tables,
                                            start_pos, n_tokens, window)
    if q.dim() != 5:
        raise ValueError("q must be (S, T, KV, G, D)")
    _check(q, k_pool, v_pool, block_tables, start_pos, n_tokens)
    S, T, KV, G, D = q.shape
    NB, bs = k_pool.shape[:2]
    out = torch.empty_like(q)
    if S * T * KV == 0:
        return out
    lib = _lib()
    with torch.cuda.device(q.device):
        rc = lib.repro_paged_verify(
            _DTYPES[q.dtype], q.data_ptr(), k_pool.data_ptr(),
            v_pool.data_ptr(), block_tables.data_ptr(), start_pos.data_ptr(),
            n_tokens.data_ptr(), out.data_ptr(), S, T, KV, G, D, NB, bs,
            block_tables.shape[1], int(window),
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, lib, "paged_verify_attention")
    _build.launches["paged_verify"] += 1
    return out
