"""Plain PyTorch versions of the RMSNorm kernels: the CPU path of the
wrappers in ``ops.py`` and the yardstick the CUDA kernels are held to.

Same math as the JAX package's Pallas kernels (``src/repro/kernels/
rmsnorm/kernel.py``): f32 statistics, output in the input's dtype; the
residual variant normalises the unrounded f32 sum ``x + residual``."""
from __future__ import annotations

import torch


def rmsnorm_plain(x: torch.Tensor, scale: torch.Tensor,
                  eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def rmsnorm_residual_plain(x: torch.Tensor, residual: torch.Tensor,
                           scale: torch.Tensor, eps: float = 1e-5):
    """Returns (rmsnorm(x + residual), x + residual), both in x's dtype."""
    s = x.float() + residual.float()
    return rmsnorm_plain(s, scale, eps).to(x.dtype), s.to(x.dtype)
