"""Quantize wrappers of the outer-sync wire: the hand-written CUDA kernels
(``csrc/quantize.cu``) for CUDA tensors, the plain versions (``ref.py``)
for CPU tensors.  They mirror the JAX package's
``repro/kernels/quantize/ops.py`` ``quantize_ef`` / ``dequantize``:

* ``quantize_ef(x, residual, dtype=, tile=)`` — fused quantize + error
  feedback residual of a (K, ...) leaf, flattened to (K, M); ``tile=0``
  gives one scale per row shaped ``(K, 1, ..., 1)``, ``tile > 0`` one
  scale per ``tile`` elements of a row, shaped ``(K, padded_M // tile)``
  as over the JAX wrapper's zero-padded layout (the kernel needs no
  padding: it treats a ragged last tile's missing columns as zeros);
* ``dequantize(q, scale, tile=)`` — the inverse.

Scalar (0-d) leaves run as a (1, 1) view and 0-size leaves take the plain
version without a launch, here in the wrapper and not in the kernel, as
in the JAX package.  The kernel takes float32 rows (other float inputs
are cast first), at most 65535 rows of fewer than 2**31 elements."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.quantize.ref import (dequantize_plain,
                                              quantize_ef_plain,
                                              target_dtype)

_P, _L, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_SIGNATURES = {
    "repro_quantize_ef": (_I,) + (_P,) * 6 + (_L,) * 3 + (_P,),
    "repro_dequantize": (_I,) + (_P,) * 3 + (_L,) * 3 + (_P,),
}
_QDTYPES = {torch.int8: 0, torch.float8_e4m3fn: 1, torch.float8_e5m2: 2}
_MAX_ROWS = 65535


def _lib():
    return _build.load("quantize", _SIGNATURES)


def _rows(t: torch.Tensor):
    k = t.shape[0]
    m = t.numel() // k
    if t.device.type != "cuda":
        raise ValueError(f"quantize kernels take CPU or CUDA tensors, got "
                         f"{t.device}")
    if k > _MAX_ROWS or m >= 2 ** 31:
        raise ValueError(f"quantize kernel takes at most {_MAX_ROWS} rows "
                         f"of fewer than 2**31 elements, got ({k}, {m})")
    return k, m


def _check_tile(tile: int) -> None:
    if tile < 0:
        raise ValueError(f"tile must be >= 0, got {tile}")


def quantize_ef(x: torch.Tensor, residual=None, *, dtype: str = "int8",
                tile: int = 0):
    """Per-row (``tile=0``) or per-tile symmetric quantize of ``x`` (K,
    ...) with the error-feedback ``residual`` (or None).  Returns ``(q,
    new_residual, scale)``; see the module docstring for the shapes."""
    _check_tile(tile)
    if x.device.type == "cpu":
        return quantize_ef_plain(x, residual, dtype=dtype, tile=tile)
    if x.dim() == 0:
        q, nr, s = quantize_ef(
            x.reshape(1, 1), None if residual is None
            else residual.reshape(1, 1), dtype=dtype, tile=tile)
        return q.reshape(()), nr.reshape(()), s.reshape(())
    if x.numel() == 0:
        return quantize_ef_plain(x, residual, dtype=dtype, tile=tile)
    k, m = _rows(x)
    xf = x.float().contiguous()
    rf = None
    if residual is not None:
        if residual.shape != x.shape or residual.device != x.device:
            raise ValueError(f"residual must match x: {tuple(x.shape)} on "
                             f"{x.device}, got {tuple(residual.shape)} on "
                             f"{residual.device}")
        rf = residual.float().contiguous()
    qt = target_dtype(dtype)
    q = torch.empty((k, m), dtype=qt, device=x.device)
    nr = torch.empty((k, m), dtype=torch.float32, device=x.device)
    nt = -(-m // tile) if tile else 1
    s = torch.empty((k, nt), dtype=torch.float32, device=x.device)
    amax = torch.empty(k, dtype=torch.float32, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        rc = lib.repro_quantize_ef(
            _QDTYPES[qt], xf.data_ptr(), 0 if rf is None else rf.data_ptr(),
            q.data_ptr(), nr.data_ptr(), s.data_ptr(), amax.data_ptr(), k, m,
            tile, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, lib, "quantize_ef")
    _build.launches["quantize_ef"] += 1
    if not tile:
        s = s.reshape((k,) + (1,) * (x.dim() - 1))
    return q.reshape(x.shape), nr.reshape(x.shape), s


def dequantize(q: torch.Tensor, scale: torch.Tensor, *, tile: int = 0):
    """Narrow (K, ...) payload times its scales -> f32.  ``tile`` must be
    the granularity ``quantize_ef`` ran with."""
    _check_tile(tile)
    if q.device.type == "cpu":
        return dequantize_plain(q, scale, tile=tile)
    if q.dim() == 0:
        return dequantize(q.reshape(1, 1), scale.reshape(1, 1)).reshape(())
    if q.numel() == 0:
        return dequantize_plain(q, scale, tile=tile)
    k, m = _rows(q)
    if q.dtype not in _QDTYPES:
        raise TypeError(f"dequantize kernel takes int8 / float8_e4m3fn / "
                        f"float8_e5m2 payloads, got {q.dtype}")
    nt = -(-m // tile) if tile else 1
    if scale.numel() != k * nt or scale.device != q.device:
        raise ValueError(f"scale must hold {k * nt} values on {q.device}, "
                         f"got {tuple(scale.shape)} on {scale.device}")
    qc = q.contiguous()
    sc = scale.float().contiguous()
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    lib = _lib()
    with torch.cuda.device(q.device):
        rc = lib.repro_dequantize(
            _QDTYPES[q.dtype], qc.data_ptr(), sc.data_ptr(), out.data_ptr(),
            k, m, tile, torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, lib, "dequantize")
    _build.launches["dequantize"] += 1
    return out
