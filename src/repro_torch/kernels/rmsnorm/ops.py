"""RMSNorm wrappers: the hand-written CUDA kernels (``csrc/rmsnorm.cu``)
for CUDA tensors, the plain versions (``ref.py``) for CPU tensors.

x may have any leading dims (rows are everything but the last); it is
float32 or bfloat16 and contiguous, with a float32 ``scale`` of shape
(d,) on the same device.  Outputs are new tensors in x's dtype.

``rmsnorm`` and ``rmsnorm_residual`` are differentiable: each is a
``torch.autograd.Function`` whose backward is ``rmsnorm_bwd`` (the CUDA
backward kernel on the card, its plain version on the CPU).  Without a
tensor that requires grad they run the forward alone, as serving does."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.rmsnorm.ref import (rmsnorm_bwd_plain,
                                              rmsnorm_plain,
                                              rmsnorm_residual_plain)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "repro_rmsnorm": (_I, _P, _P, _P, _I, _I, _F, _P),
    "repro_rmsnorm_residual": (_I, _P, _P, _P, _P, _P, _I, _I, _F, _P),
    "repro_rmsnorm_bwd": (_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                          _I, _F, _P),
}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the backward keeps one f32 dscale partial of d floats in shared memory
_MAX_BWD_D = 48 * 1024 // 4
# CTAs of the backward: about two per SM of an H100
_BWD_CTAS = 264


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


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _rmsnorm_fwd(x: torch.Tensor, scale: torch.Tensor,
                 eps: float) -> torch.Tensor:
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
            rows, x.shape[-1], eps, _stream(x))
    _build.check(rc, lib, "rmsnorm")
    _build.launches["rmsnorm"] += 1
    return out


def _rmsnorm_residual_fwd(x: torch.Tensor, residual: torch.Tensor,
                          scale: torch.Tensor, eps: float):
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
            x.shape[-1], eps, _stream(x))
    _build.check(rc, lib, "rmsnorm_residual")
    _build.launches["rmsnorm_residual"] += 1
    return out, new_res


def rmsnorm_bwd(dy: torch.Tensor, x: torch.Tensor, scale: torch.Tensor, *,
                eps: float = 1e-5, residual=None, dh=None):
    """Gradient of ``rmsnorm`` (``residual`` None) or ``rmsnorm_residual``
    at the forward's inputs: returns (ds in x's dtype, dscale f32 (d,)),
    ds being the gradient of x (and of residual).  ``dh`` is the gradient
    arriving at the residual variant's second output."""
    if x.device.type == "cpu":
        return rmsnorm_bwd_plain(dy, x, scale, eps, residual, dh)
    if (residual is None) != (dh is None):
        raise ValueError("the residual backward takes both residual and dh")
    extra = (dy,) if residual is None else (dy, residual, dh)
    _check(x, scale, *extra)
    rows, d = x.numel() // x.shape[-1], x.shape[-1]
    if d > _MAX_BWD_D:
        raise ValueError(f"rmsnorm backward kernel takes d <= {_MAX_BWD_D}, "
                         f"got {d}")
    dx = torch.empty_like(x)
    dscale = torch.empty(d, dtype=torch.float32, device=x.device)
    if rows == 0:
        return dx, dscale.zero_()
    per_cta = -(-rows // min(rows, _BWD_CTAS))
    partial = torch.empty((-(-rows // per_cta), d), dtype=torch.float32,
                          device=x.device)
    res = x if residual is None else residual
    dh_ = dy if dh is None else dh
    lib = _lib()
    with torch.cuda.device(x.device):
        rc = lib.repro_rmsnorm_bwd(
            _DTYPES[x.dtype], int(residual is not None), x.data_ptr(),
            res.data_ptr(), scale.data_ptr(), dy.data_ptr(), dh_.data_ptr(),
            dx.data_ptr(), partial.data_ptr(), dscale.data_ptr(), rows, d,
            per_cta, eps, _stream(x))
    _build.check(rc, lib, "rmsnorm_bwd")
    _build.launches["rmsnorm_bwd"] += 1
    return dx, dscale


class _RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return _rmsnorm_fwd(x, scale, eps)

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        dx, dscale = rmsnorm_bwd(dy.contiguous(), x, scale, eps=ctx.eps)
        return dx, dscale, None


class _RMSNormResidual(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, residual, scale, eps):
        ctx.save_for_backward(x, residual, scale)
        ctx.eps = eps
        return _rmsnorm_residual_fwd(x, residual, scale, eps)

    @staticmethod
    def backward(ctx, dy, dh):
        x, residual, scale = ctx.saved_tensors
        d, dscale = rmsnorm_bwd(dy.contiguous(), x, scale, eps=ctx.eps,
                                residual=residual, dh=dh.contiguous())
        return d, d, dscale, None


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, *,
            eps: float = 1e-5) -> torch.Tensor:
    return _RMSNorm.apply(x, scale, eps)


def rmsnorm_residual(x: torch.Tensor, residual: torch.Tensor,
                     scale: torch.Tensor, *, eps: float = 1e-5):
    """Fused ``s = x + residual`` -> RMSNorm.  Returns (normed, s)."""
    return _RMSNormResidual.apply(x, residual, scale, eps)
