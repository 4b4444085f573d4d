"""Symmetric quantization in plain PyTorch: the port's copy of the JAX
package's ``repro.kernels.quantize`` constants and of its oracles
(``src/repro/kernels/quantize/ref.py``).

* ``quantize_axis`` — one scale per slice along an axis, no error
  feedback: the quantize-on-scatter primitive of the quantized paged KV
  pool (jnp in the JAX package, no Pallas kernel, so plain torch on the
  card as well);
* ``reference_quantize_ef`` / ``reference_dequantize`` — per-row
  (per-tensor-per-worker) quantization with an error-feedback residual,
  the semantics of the outer-sync wire;
* ``quantize_ef_plain`` / ``dequantize_plain`` — the same with the
  per-tile granularity of the JAX wrapper (``tile > 0``: one scale per
  ``tile`` flattened elements of a row, over the zero-padded layout).
  These are the plain versions of the CUDA kernels in
  ``csrc/quantize.cu``: the CPU path of ``ops.py`` and the yardstick the
  kernels are held to, bit for bit.

The numerics follow the reference op for op, so the payloads agree bit
for bit, on the CPU and on the card: ``scale = max(amax, SCALE_EPS) /
QMAX`` in f32 and ``e / scale``, both true divisions; round half to even
for int8; the clip to ±QMAX BEFORE the cast (``float8_e4m3fn`` has no
inf: PyTorch turns an overflow into NaN); and the residual ``e - q *
scale`` as a product and a difference, each rounded."""
from __future__ import annotations

import functools

import torch

SCALE_EPS = 1e-12

# symmetric clip bound per target (the finfo / iinfo max of each)
QMAX = {"int8": 127.0, "fp8_e4m3": 448.0, "fp8_e5m2": 57344.0}
QDTYPES = ("int8", "fp8_e4m3", "fp8_e5m2")
_TARGETS = {"int8": torch.int8, "fp8_e4m3": torch.float8_e4m3fn,
            "fp8_e5m2": torch.float8_e5m2}


def target_dtype(dtype: str) -> torch.dtype:
    """torch dtype of a quantize target name (raises on unknown names)."""
    if dtype not in _TARGETS:
        raise ValueError(f"unknown quantize target {dtype!r}; expected one "
                         f"of {QDTYPES}")
    return _TARGETS[dtype]


@functools.lru_cache(maxsize=None)
def _qmax(dtype: str, device: torch.device) -> torch.Tensor:
    """QMAX as a 0-d f32 tensor on ``device``, made once.  Dividing by a
    Python scalar would not do: PyTorch's CUDA division by one multiplies
    by its reciprocal, one ulp off the true quotient."""
    return torch.tensor(QMAX[dtype], dtype=torch.float32, device=device)


def _narrow(e: torch.Tensor, scale: torch.Tensor, dtype: str) -> torch.Tensor:
    """Clip (and round, for int8) ``e / scale``, then cast."""
    qmax = QMAX[dtype]
    y = e / scale
    if dtype == "int8":
        y = torch.round(y)
    return y.clamp(-qmax, qmax).to(target_dtype(dtype))


def quantize_axis(x: torch.Tensor, axis: int = -1,
                  dtype: str = "fp8_e4m3"):
    """One amax scale per slice along ``axis`` (keepdims).  Returns
    ``(payload in target_dtype(dtype), scale f32)``."""
    e = x.float()
    if e.numel() == 0:
        shape = list(e.shape)
        shape[axis] = 1
        return (e.to(target_dtype(dtype)),
                torch.ones(shape, dtype=torch.float32, device=e.device))
    amax = e.abs().amax(dim=axis, keepdim=True)
    scale = amax.clamp(min=SCALE_EPS) / _qmax(dtype, amax.device)
    return _narrow(e, scale, dtype), scale


def reference_quantize_ef(x: torch.Tensor, residual=None,
                          dtype: str = "int8"):
    """Per-row symmetric quantization with error feedback.  ``x``: (K, ...)
    — one row per worker; the scales reduce over every non-leading axis.
    Returns ``(q, new_residual, scale)`` with ``scale`` shaped ``(K, 1, ...,
    1)``.  Scalar (0-d) leaves quantize elementwise; 0-size leaves pass
    through with unit scales."""
    e = x.float()
    if residual is not None:
        e = e + residual.float()
    axes = tuple(range(1, e.dim()))
    if e.numel() == 0:
        scale = torch.ones(e.shape[:1] + (1,) * len(axes),
                           dtype=torch.float32, device=e.device)
        return e.to(target_dtype(dtype)), e, scale
    amax = e.abs().amax(dim=axes, keepdim=True) if axes else e.abs()
    scale = amax.clamp(min=SCALE_EPS) / _qmax(dtype, e.device)
    q = _narrow(e, scale, dtype)
    return q, e - q.float() * scale, scale


def reference_dequantize(q: torch.Tensor, scale: torch.Tensor):
    return q.float() * scale


def _tiles(t: torch.Tensor, tile: int) -> torch.Tensor:
    """(K, ...) -> (K, n_tiles, tile), zero-padded: the JAX wrapper's
    ``_flatten_pad`` layout seen tile by tile."""
    flat = t.reshape(t.shape[0], -1)
    pad = (-flat.shape[1]) % tile
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    return flat.reshape(flat.shape[0], -1, tile)


def _untile(t: torch.Tensor, shape) -> torch.Tensor:
    m = 1
    for n in shape[1:]:
        m *= n
    return t.reshape(t.shape[0], -1)[:, :m].reshape(shape)


def quantize_ef_plain(x: torch.Tensor, residual=None, *, dtype: str = "int8",
                      tile: int = 0):
    """The ``quantize_ef`` wrapper's semantics in plain torch.  ``tile=0``
    is :func:`reference_quantize_ef`; ``tile > 0`` gives one scale per
    ``tile`` elements of each flattened row, shaped ``(K, padded_M //
    tile)`` (the padding is zeros, which add nothing to an amax)."""
    if x.dim() == 0:
        q, nr, s = quantize_ef_plain(
            x.reshape(1, 1), None if residual is None
            else residual.reshape(1, 1), dtype=dtype, tile=tile)
        return q.reshape(()), nr.reshape(()), s.reshape(())
    if not tile or x.numel() == 0:
        return reference_quantize_ef(x, residual, dtype)
    e = x.float()
    if residual is not None:
        e = e + residual.float()
    et = _tiles(e, tile)
    scale = (et.abs().amax(dim=-1, keepdim=True).clamp(min=SCALE_EPS)
             / _qmax(dtype, e.device))
    q = _narrow(et, scale, dtype)
    nr = et - q.float() * scale
    return _untile(q, x.shape), _untile(nr, x.shape), scale[..., 0]


def dequantize_plain(q: torch.Tensor, scale: torch.Tensor, *, tile: int = 0):
    """Inverse of :func:`quantize_ef_plain` (``tile`` as it was run)."""
    if q.dim() == 0:
        return dequantize_plain(q.reshape(1, 1), scale.reshape(1, 1),
                                tile=0).reshape(())
    if not tile or q.numel() == 0:
        return q.float() if q.numel() == 0 else reference_dequantize(q,
                                                                     scale)
    out = _tiles(q.float(), tile) * scale.reshape(q.shape[0], -1, 1)
    return _untile(out, q.shape)
