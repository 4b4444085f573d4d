"""RMSNorm wrappers: the hand-written CUDA kernels (``csrc/rmsnorm.cu``)
for CUDA tensors, the plain versions (``ref.py``) for CPU tensors.

x may have any leading dims (rows are everything but the last); it is
float32 or bfloat16 and contiguous, with a float32 ``scale`` of shape
(d,) on the same device.  Outputs are new tensors in x's dtype.

On the card a row lives in registers: :func:`layout` gives, from d and
the dtype alone, the threads that share a row (one warp up to
``WARP_MAX_D``, a CTA of ``CTA_THREADS`` above) and the 16-byte vectors
each thread holds (``TILES``: the tiles the kernels are built for).  The
row count never enters it, so a row's bits do not depend on how many
rows share its launch.  The kernels take d a multiple of 8 up to
``MAX_D`` and operands on 16-byte boundaries; the wrappers raise
``ValueError`` on anything else.  The backward runs persistent CTAs, as
many as fit on the card's SMs (``multi_processor_count``), and sums
dscale without atomics, in a fixed order.

``rmsnorm`` and ``rmsnorm_residual`` are differentiable: each is a
``torch.autograd.Function`` whose backward is ``rmsnorm_bwd`` (the CUDA
backward kernel on the card, its plain version on the CPU).  Without a
tensor that requires grad they run the forward alone, as serving does."""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.rmsnorm.ref import (rmsnorm_bwd_plain,
                                              rmsnorm_plain,
                                              rmsnorm_residual_plain)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "repro_rmsnorm": (_I, _P, _P, _P, _I, _I, _I, _I, _F, _P),
    "repro_rmsnorm_residual": (_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F,
                               _P),
    "repro_rmsnorm_bwd": (_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                          _I, _I, _I, _F, _P),
}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
WARP_MAX_D = 2048          # rows up to this width belong to one warp
MAX_D = 12288              # the widest d_model of the JAX package's configs
CTA_THREADS = 256          # threads of one row above WARP_MAX_D
# 16-byte vectors per thread the kernels are built for, by (threads per
# row, dtype): csrc/rmsnorm.cu TILES_* instantiates the same
TILES = {(32, torch.float32): (1, 2, 4, 6, 8, 10, 12, 14, 16),
         (32, torch.bfloat16): (1, 2, 4, 6, 8),
         (CTA_THREADS, torch.float32): (4, 6, 8, 10, 12),
         (CTA_THREADS, torch.bfloat16): (2, 4, 6)}
# threads of a backward CTA (csrc kBwdThreads): 8 rows at once in warps,
# one above WARP_MAX_D
_BWD_THREADS = 256
# the most CTAs of 256 threads an SM holds (2048 threads)
_MAX_CTAS_PER_SM = 8


class Layout(NamedTuple):
    threads: int           # threads that share one row: 32 or CTA_THREADS
    tile: int              # 16-byte vectors each thread holds


def layout(d: int, dtype: torch.dtype) -> Layout:
    """How the kernels lay a row of ``d`` elements of ``dtype`` over
    threads: from d and the dtype alone, never the row count.  Raises
    ``ValueError`` for a d the kernels do not take (not a positive
    multiple of 8, or above ``MAX_D``)."""
    if dtype not in _DTYPES:
        raise TypeError(f"rmsnorm kernel takes float32 or bfloat16, "
                        f"got {dtype}")
    if d <= 0 or d % 8 or d > MAX_D:
        raise ValueError(f"rmsnorm kernels take d a multiple of 8 up to "
                         f"{MAX_D}, got {d}")
    threads = 32 if d <= WARP_MAX_D else CTA_THREADS
    per_vector = 16 // dtype.itemsize
    need = -(-d // (per_vector * threads))
    return Layout(threads, next(t for t in TILES[threads, dtype]
                                if t >= need))


def _check(x: torch.Tensor, scale: torch.Tensor,
           *others: torch.Tensor) -> Layout:
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm takes CPU or CUDA tensors, got {x.device}")
    d = x.shape[-1]
    lay = layout(d, x.dtype)
    if scale.dtype != torch.float32 or tuple(scale.shape) != (d,):
        raise ValueError(f"scale must be float32 of shape ({d},), got "
                         f"{scale.dtype} {tuple(scale.shape)}")
    for t in (x, scale) + others:
        if t.device != x.device:
            raise ValueError("rmsnorm operands must share one device")
        if not t.is_contiguous():
            raise ValueError("rmsnorm kernel takes contiguous tensors")
        if t.data_ptr() % 16:
            raise ValueError("rmsnorm kernel takes operands on 16-byte "
                             "boundaries (16-byte vector loads)")
    for t in others:
        if t.shape != x.shape or t.dtype != x.dtype:
            raise ValueError("residual must match x in shape and dtype")
    return lay


def _lib():
    return _build.load("rmsnorm", _SIGNATURES)


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _rmsnorm_fwd(x: torch.Tensor, scale: torch.Tensor,
                 eps: float) -> torch.Tensor:
    if x.device.type == "cpu":
        return rmsnorm_plain(x, scale, eps)
    lay = _check(x, scale)
    out = torch.empty_like(x)
    rows = x.numel() // x.shape[-1]
    if rows == 0:
        return out
    lib = _lib()
    with torch.cuda.device(x.device):
        rc = lib.repro_rmsnorm(
            _DTYPES[x.dtype], x.data_ptr(), scale.data_ptr(), out.data_ptr(),
            rows, x.shape[-1], lay.threads, lay.tile, eps, _stream(x))
    _build.check(rc, lib, "rmsnorm")
    _build.launches["rmsnorm"] += 1
    return out


def _rmsnorm_residual_fwd(x: torch.Tensor, residual: torch.Tensor,
                          scale: torch.Tensor, eps: float):
    if x.device.type == "cpu":
        return rmsnorm_residual_plain(x, residual, scale, eps)
    lay = _check(x, scale, residual)
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
            x.shape[-1], lay.threads, lay.tile, eps, _stream(x))
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
    lay = _check(x, scale, *extra)
    rows, d = x.numel() // x.shape[-1], x.shape[-1]
    dx = torch.empty_like(x)
    dscale = torch.empty(d, dtype=torch.float32, device=x.device)
    if rows == 0:
        return dx, dscale.zero_()
    # CTAs the kernel may run: no more than it has row groups for, nor
    # than the card's SMs hold at once (the kernel takes the occupancy)
    groups = -(-rows // (_BWD_THREADS // lay.threads))
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    max_ctas = min(groups, sms * _MAX_CTAS_PER_SM)
    partial = torch.empty((max_ctas, d), dtype=torch.float32,
                          device=x.device)
    res = x if residual is None else residual
    dh_ = dy if dh is None else dh
    lib = _lib()
    with torch.cuda.device(x.device):
        rc = lib.repro_rmsnorm_bwd(
            _DTYPES[x.dtype], int(residual is not None), x.data_ptr(),
            res.data_ptr(), scale.data_ptr(), dy.data_ptr(), dh_.data_ptr(),
            dx.data_ptr(), partial.data_ptr(), dscale.data_ptr(), rows, d,
            lay.threads, lay.tile, max_ctas, eps, _stream(x))
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
