"""RMSNorm wrappers: the hand-written CUDA kernels (``csrc/rmsnorm.cu``)
for CUDA tensors, the plain versions (``ref.py``) for CPU tensors.

x may have any leading dims (rows are everything but the last); it is
float32 or bfloat16 and contiguous, with a float32 ``scale`` of shape
(d,) on the same device.  Outputs are new tensors in x's dtype."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.rmsnorm.ref import (rmsnorm_plain,
                                              rmsnorm_residual_plain)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "repro_rmsnorm": (_I, _P, _P, _P, _I, _I, _F, _P),
    "repro_rmsnorm_residual": (_I, _P, _P, _P, _P, _P, _I, _I, _F, _P),
}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check(x: torch.Tensor, scale: torch.Tensor, *others: torch.Tensor):
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm takes CPU or CUDA tensors, got {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"rmsnorm kernel takes float32 or bfloat16, "
                        f"got {x.dtype}")
    d = x.shape[-1]
    if scale.dtype != torch.float32 or tuple(scale.shape) != (d,):
        raise ValueError(f"scale must be float32 of shape ({d},), got "
                         f"{scale.dtype} {tuple(scale.shape)}")
    for t in (x, scale) + others:
        if t.device != x.device:
            raise ValueError("rmsnorm operands must share one device")
        if not t.is_contiguous():
            raise ValueError("rmsnorm kernel takes contiguous tensors")
    for t in others:
        if t.shape != x.shape or t.dtype != x.dtype:
            raise ValueError("residual must match x in shape and dtype")


def _lib():
    return _build.load("rmsnorm", _SIGNATURES)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, *,
            eps: float = 1e-5) -> torch.Tensor:
    if x.device.type == "cpu":
        return rmsnorm_plain(x, scale, eps)
    _check(x, scale)
    out = torch.empty_like(x)
    rows = x.numel() // x.shape[-1]
    if rows == 0:
        return out
    lib = _lib()
    with torch.cuda.device(x.device):
        rc = lib.repro_rmsnorm(
            _DTYPES[x.dtype], x.data_ptr(), scale.data_ptr(), out.data_ptr(),
            rows, x.shape[-1], eps,
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, lib, "rmsnorm")
    _build.launches["rmsnorm"] += 1
    return out


def rmsnorm_residual(x: torch.Tensor, residual: torch.Tensor,
                     scale: torch.Tensor, *, eps: float = 1e-5):
    """Fused ``s = x + residual`` -> RMSNorm.  Returns (normed, s)."""
    if x.device.type == "cpu":
        return rmsnorm_residual_plain(x, residual, scale, eps)
    _check(x, scale, residual)
    out = torch.empty_like(x)
    new_res = torch.empty_like(x)
    rows = x.numel() // x.shape[-1]
    if rows == 0:
        return out, new_res
    lib = _lib()
    with torch.cuda.device(x.device):
        rc = lib.repro_rmsnorm_residual(
            _DTYPES[x.dtype], x.data_ptr(), residual.data_ptr(),
            scale.data_ptr(), out.data_ptr(), new_res.data_ptr(), rows,
            x.shape[-1], eps,
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, lib, "rmsnorm_residual")
    _build.launches["rmsnorm_residual"] += 1
    return out, new_res
