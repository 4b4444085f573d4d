"""Symmetric per-slice quantization in plain PyTorch: the port's copy of
the JAX package's ``repro.kernels.quantize`` constants and of its
``reference_quantize_axis`` (``src/repro/kernels/quantize/ref.py``).

This is the quantize-on-scatter primitive of the quantized paged KV pool:
each fresh (token, KV head) row of K and V gets one amax scale over the
head dim and a 1-byte payload.  The JAX package computes it in jnp (no
Pallas kernel), so here it is plain torch on the card as well.  The
numerics follow the reference op for op, so the payloads agree bit for
bit, on the CPU and on the card: ``scale = max(amax, SCALE_EPS) / QMAX``
in f32 and ``e / scale``, both true divisions; round half to even for
int8; and the clip to ±QMAX BEFORE the cast (``float8_e4m3fn`` has no
inf: PyTorch turns an overflow into NaN)."""
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
