"""Fused AdamW wrapper: the hand-written CUDA kernel
(``csrc/fused_adamw.cu``) for CUDA tensors, the plain version (``ref.py``)
for CPU tensors.

One leaf of any shape and length: p and g float32 or bfloat16, m and v
float32, all contiguous on one device; ``lr``, ``bc1`` and ``bc2`` are f32
0-d tensors on that device (the schedule value and bias corrections of the
step), handed to the kernel as a 3-float device array, never as
compile-time constants.  Returns new (update, m', v') tensors, all f32."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.fused_adamw.ref import fused_adamw_plain

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "repro_fused_adamw": (_I, _I) + (_P,) * 8 + (ctypes.c_longlong,)
    + (_F,) * 6 + (_P,),
}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check(p, g, m, v, scal):
    if p.device.type != "cuda":
        raise ValueError(f"fused_adamw takes CPU or CUDA tensors, got "
                         f"{p.device}")
    for t in (p, g):
        if t.dtype not in _DTYPES:
            raise TypeError(f"fused_adamw kernel takes float32 or bfloat16 "
                            f"p and g, got {t.dtype}")
    for t in (m, v, scal):
        if t.dtype != torch.float32:
            raise TypeError("fused_adamw moments and scalars must be float32")
    for t in (g, m, v):
        if t.shape != p.shape:
            raise ValueError(f"g, m and v must have p's shape "
                             f"{tuple(p.shape)}, got {tuple(t.shape)}")
    for t in (p, g, m, v, scal):
        if t.device != p.device:
            raise ValueError("fused_adamw operands must share one device")
        if not t.is_contiguous():
            raise ValueError("fused_adamw kernel takes contiguous tensors")


def _lib():
    return _build.load("fused_adamw", _SIGNATURES)


def fused_adamw_update(p, g, m, v, lr, bc1, bc2, *, b1: float, b2: float,
                       eps: float, wd: float):
    """One fused AdamW step on one leaf.  Returns (update, new_m, new_v)."""
    if p.device.type == "cpu":
        return fused_adamw_plain(p, g, m, v, lr, bc1, bc2, b1=b1, b2=b2,
                                 eps=eps, wd=wd)
    scal = torch.stack([torch.as_tensor(x, dtype=torch.float32,
                                        device=p.device).reshape(())
                        for x in (lr, bc1, bc2)])
    _check(p, g, m, v, scal)
    u = torch.empty(p.shape, dtype=torch.float32, device=p.device)
    new_m, new_v = torch.empty_like(u), torch.empty_like(u)
    n = p.numel()
    if n == 0:
        return u, new_m, new_v
    lib = _lib()
    with torch.cuda.device(p.device):
        rc = lib.repro_fused_adamw(
            _DTYPES[p.dtype], _DTYPES[g.dtype], p.data_ptr(), g.data_ptr(),
            m.data_ptr(), v.data_ptr(), scal.data_ptr(), u.data_ptr(),
            new_m.data_ptr(), new_v.data_ptr(), n, b1, 1 - b1, b2, 1 - b2,
            eps, wd, torch.cuda.current_stream(p.device).cuda_stream)
    _build.check(rc, lib, "fused_adamw")
    _build.launches["fused_adamw"] += 1
    return u, new_m, new_v
