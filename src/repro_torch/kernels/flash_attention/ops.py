"""Flash attention wrappers: the hand-written CUDA kernels
(``csrc/flash_attention.cu``) for CUDA tensors, the plain versions
(``ref.py``) for CPU tensors, and ``flash_attention``, the
``torch.autograd.Function`` that ties the forward to its backward.

Layout (the model's, see ``ref.py``): q (B, S, H, D), k/v (B, S, KV, D),
H % KV == 0, all one dtype (float32 or bfloat16), contiguous, one device.
``causal`` masks keys after the query; ``window`` > 0 keeps only keys
with query - key < window.  The CUDA kernels take head dims 16, 32, 64
and 128 and any S.  ``flash_fwd(..., fp8=True)`` runs QK^T on per-row
fp8_e4m3 codes (the JAX kernel's ``fp8=True``); it is forward only, as
the JAX kernel is, so the backward and ``flash_attention`` refuse it."""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import (
    flash_attention_bwd_plain, flash_attention_fp8_plain,
    flash_attention_plain)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_FWD = (_I, _P, _P, _P, _P, _P) + (_I,) * 5 + (_F, _I, _I, _P)
_SIGNATURES = {
    "repro_flash_fwd": _FWD,
    "repro_flash_fwd_fp8": _FWD,
    "repro_flash_bwd": (_I,) + (_P,) * 10 + (_I,) * 5 + (_F, _I, _I, _P),
}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64, 128)


def _check(q, k, v, *others):
    if q.device.type != "cuda":
        raise ValueError(f"flash attention takes CPU or CUDA tensors, got "
                         f"{q.device}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash attention kernel takes float32 or bfloat16, "
                        f"got {q.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError("q must be (B, S, H, D) and k/v both (B, S, KV, D)")
    B, S, H, D = q.shape
    if (k.shape[0], k.shape[1], k.shape[3]) != (B, S, D) or H % k.shape[2]:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)} (H % KV must be 0)")
    if D not in _HEAD_DIMS:
        raise ValueError(f"flash attention kernel takes head dims "
                         f"{_HEAD_DIMS}, got {D}")
    for t in (q, k, v) + others:
        if t.device != q.device:
            raise ValueError("flash attention operands must share one device")
        if not t.is_contiguous():
            raise ValueError("flash attention kernel takes contiguous "
                             "tensors")
    for t in (k, v) + others:
        if t.dtype != q.dtype:
            raise TypeError("flash attention operands must share q's dtype")


def _lib():
    return _build.load("flash_attention", _SIGNATURES)


def _flags(causal: bool, window: Optional[int]):
    return int(bool(causal)), int(window or 0)


def _refuse_fp8(fp8: bool, what: str) -> None:
    if fp8:
        raise ValueError(f"{what}: the fp8 QK^T flash attention is forward "
                         f"only (the JAX kernel has no backward)")


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: Optional[int] = None,
              fp8: bool = False):
    """Returns (o (B, S, H, D) in q's dtype, lse (B, H, S) f32).
    ``fp8``: QK^T on per-row fp8_e4m3 codes of q and k."""
    if q.device.type == "cpu":
        plain = flash_attention_fp8_plain if fp8 else flash_attention_plain
        return plain(q, k, v, causal, window)
    _check(q, k, v)
    B, S, H, D = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    if B * S * H == 0:
        return o, lse
    lib = _lib()
    name = "flash_fwd_fp8" if fp8 else "flash_fwd"
    with torch.cuda.device(q.device):
        rc = getattr(lib, f"repro_{name}")(
            _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            o.data_ptr(), lse.data_ptr(), B, S, H, k.shape[2], D,
            1.0 / math.sqrt(D), *_flags(causal, window),
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, lib, name)
    _build.launches[name] += 1
    return o, lse


def flash_bwd(q, k, v, o, lse, do, *, causal: bool = True,
              window: Optional[int] = None, fp8: bool = False):
    """Gradients (dq, dk, dv) of the forward's output given its output
    ``o``, its ``lse`` and the output gradient ``do`` (same shape as q).
    ``fp8=True`` raises ``ValueError``: that forward has no backward."""
    _refuse_fp8(fp8, "flash_bwd")
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, lse, do, causal, window)
    _check(q, k, v, o, do)
    B, S, H, D = q.shape
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError("o and do must have q's shape")
    if (lse.dtype != torch.float32 or tuple(lse.shape) != (B, H, S)
            or lse.device != q.device or not lse.is_contiguous()):
        raise ValueError(f"lse must be contiguous float32 ({B}, {H}, {S}) on "
                         f"{q.device}")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if B * S * H == 0:
        return dq, dk, dv
    delta = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    lib = _lib()
    with torch.cuda.device(q.device):
        rc = lib.repro_flash_bwd(
            _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            o.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, S, H, k.shape[2],
            D, 1.0 / math.sqrt(D), *_flags(causal, window),
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, lib, "flash_bwd")
    _build.launches["flash_bwd"] += 1
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        o, lse = flash_fwd(q, k, v, causal=causal, window=window)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, o, lse, do.contiguous(),
                               causal=ctx.causal, window=ctx.window)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    fp8: bool = False) -> torch.Tensor:
    """Differentiable attention output (B, S, H, D); the backward is
    ``flash_bwd``.  ``fp8=True`` raises ``ValueError`` (forward only: call
    ``flash_fwd(..., fp8=True)``)."""
    _refuse_fp8(fp8, "flash_attention")
    return _FlashAttention.apply(q, k, v, causal, window)
