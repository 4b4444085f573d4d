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


def rmsnorm_bwd_plain(dy: torch.Tensor, x: torch.Tensor, scale: torch.Tensor,
                      eps: float = 1e-5, residual=None, dh=None):
    """Gradient of :func:`rmsnorm_plain` (``residual`` None) or of
    :func:`rmsnorm_residual_plain` at (x, residual): with s = x (+ residual)
    in f32, r = rsqrt(mean(s^2) + eps) and g = dy * scale,

        ds     = r g - s r^3 mean(g s)   (+ dh, the new residual's gradient)
        dscale = sum over rows of dy s r

    Returns (ds in x's dtype, dscale f32 (d,)); for the residual variant
    ds is the gradient of both x and residual."""
    s = x.float()
    if residual is not None:
        s = s + residual.float()
    inv = torch.rsqrt(s.square().mean(dim=-1, keepdim=True) + eps)
    gy = dy.float()
    g = gy * scale.float()
    c = inv * inv * inv * (g * s).mean(dim=-1, keepdim=True)
    ds = inv * g - c * s
    if dh is not None:
        ds = ds + dh.float()
    dscale = (gy * s * inv).reshape(-1, s.shape[-1]).sum(dim=0)
    return ds.to(x.dtype), dscale
