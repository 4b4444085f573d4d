"""The Mamba-2 (SSD) block: the full-sequence forward through the SSD
scan kernel, the one-token decode, the depthwise causal conv and the
gated RMSNorm — the port of the JAX package's ``repro.models.ssm``.

Parameters are the JAX package's leaves (``in_proj`` (d, 2 d_in + 2N +
H) in the order [z, x, B, C, dt], ``conv_w`` (W, conv_dim), ``conv_b``,
``A_log``, ``D``, ``dt_bias``, ``norm_scale``, ``out_proj`` (d_in, d)),
applied as ``x @ W``.  The full-sequence forward runs the SSD scan through
``repro_torch.kernels.ssd`` (the CUDA kernel on the card, ``ssd_chunked``
on the CPU); the decode step runs the one-token recurrence
``ssd_decode_step``, plain tensor code as in the JAX package.

The decode cache {"conv": (B, W-1, conv_dim), "ssm": (B, H, N, P)} is
updated IN PLACE by ``decode_mamba`` (the JAX package returns a new one).
The step ignores the token's position, as the JAX package's does: a
left-pad token of the static prefill runs through the conv ring and the
state like any other (see ``serving/engine.py``).

``d_inner`` overrides ``ssm_expand * d_model`` (the hybrid archs' SSM
heads use it).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ssd import ssd, ssd_decode_step
from repro_torch.models.layers import cast


def mamba_dims(cfg: ModelConfig, d_inner: Optional[int] = None):
    """(d_in, H, N, conv_dim) of the block."""
    d_in = d_inner or cfg.ssm_expand * cfg.d_model
    H = d_in // cfg.ssm_head_dim
    N = cfg.ssm_state_size
    conv_dim = d_in + 2 * N
    return d_in, H, N, conv_dim


def mamba_param_shapes(cfg: ModelConfig, d_inner: Optional[int] = None
                       ) -> Dict[str, Tuple[int, ...]]:
    """Leaf name -> shape of one block's parameters."""
    d = cfg.d_model
    d_in, H, N, conv_dim = mamba_dims(cfg, d_inner)
    return {"in_proj": (d, 2 * d_in + 2 * N + H),
            "conv_w": (cfg.ssm_conv_width, conv_dim), "conv_b": (conv_dim,),
            "A_log": (H,), "D": (H,), "dt_bias": (H,),
            "norm_scale": (d_in,), "out_proj": (d_in, d)}


def init_mamba(g: torch.Generator, cfg: ModelConfig,
               d_inner: Optional[int] = None, *, stack: Tuple[int, ...] = (),
               dtype=torch.float32, device="cpu") -> Dict[str, torch.Tensor]:
    """Random block parameters with the JAX package's init rules, drawn
    from ``g`` (a generator on ``device``); ``stack`` prefixes every shape
    (``(L,)`` for the stacked layers):

    * ``in_proj``, ``conv_w``, ``out_proj``: truncated normal in [-3, 3]
      times 1/sqrt(fan in), fan in the second-to-last dim (``conv_w``: the
      conv width);
    * ``conv_b`` zeros; ``D`` and ``norm_scale`` ones;
    * ``A_log`` = log(U[1, 16)) (``ssm_a``);
    * ``dt_bias`` = softplus^-1(dt), dt log-uniform in [1e-3, 1e-1]
      (``ssm_dt``)."""
    out = {}
    for name, shape in mamba_param_shapes(cfg, d_inner).items():
        t = torch.empty(stack + shape, dtype=dtype, device=device)
        if name == "conv_b":
            t.zero_()
        elif name in ("D", "norm_scale"):
            t.fill_(1.0)
        elif name == "A_log":
            t.uniform_(1.0, 16.0, generator=g).log_()
        elif name == "dt_bias":
            u = torch.rand(t.shape, generator=g, dtype=dtype, device=device)
            dt = torch.exp(u * (math.log(1e-1) - math.log(1e-3))
                           + math.log(1e-3))
            t.copy_(dt + torch.log(-torch.expm1(-dt)))
        else:
            torch.nn.init.trunc_normal_(t, 0.0, 1.0, -3.0, 3.0, generator=g)
            t.mul_(1.0 / math.sqrt(shape[-2]))
        out[name] = t
    return out


def _split_proj(zxbcdt, d_in, N, H):
    z = zxbcdt[..., :d_in]
    xBC = zxbcdt[..., d_in:2 * d_in + 2 * N]
    dt = zxbcdt[..., 2 * d_in + 2 * N:]
    return z, xBC, dt


def _gated_norm(p, y, z, eps):
    y = y * F.silu(z.float())
    var = torch.mean(torch.square(y), dim=-1, keepdim=True)
    return (y * torch.rsqrt(var + eps)) * p["norm_scale"].float()


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x), as ``jax.nn.softplus`` (no threshold)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _dt_and_a(p, dt_raw):
    dt = _softplus(dt_raw.float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())
    return dt, A


def apply_mamba(p, x: torch.Tensor, cfg: ModelConfig,
                d_inner: Optional[int] = None) -> torch.Tensor:
    """Full-sequence (scoring / prefill) mamba-2 block.  x: (B, S, d)."""
    Bsz, S, _ = x.shape
    d_in, H, N, _ = mamba_dims(cfg, d_inner)
    dt_c = x.dtype
    zxbcdt = x @ cast(p["in_proj"], dt_c)
    z, xBC, dt_raw = _split_proj(zxbcdt, d_in, N, H)

    # depthwise causal conv over the (x, B, C) channels
    w = p["conv_w"].float()                                  # (W, conv_dim)
    W = w.shape[0]
    xp = F.pad(xBC.float(), (0, 0, W - 1, 0))
    conv = sum(xp[:, i:i + S] * w[i] for i in range(W)) + p["conv_b"].float()
    xBC = F.silu(conv)

    xs = xBC[..., :d_in].reshape(Bsz, S, H, cfg.ssm_head_dim)
    Bm = xBC[..., d_in:d_in + N]
    Cm = xBC[..., d_in + N:]
    dt, A = _dt_and_a(p, dt_raw)
    y, _ = ssd(xs, dt, A, Bm, Cm, p["D"], chunk=cfg.ssm_chunk)
    y = y.reshape(Bsz, S, d_in).float()
    y = _gated_norm(p, y, z, cfg.norm_eps)
    return y.to(dt_c) @ cast(p["out_proj"], dt_c)


def init_mamba_cache(cfg: ModelConfig, batch: int,
                     d_inner: Optional[int] = None, dtype=torch.float32,
                     device="cpu", stack: Tuple[int, ...] = ()
                     ) -> Dict[str, torch.Tensor]:
    """A zeroed decode cache: {"conv": stack + (B, W-1, conv_dim), "ssm":
    stack + (B, H, N, P)}."""
    d_in, H, N, conv_dim = mamba_dims(cfg, d_inner)
    return {
        "conv": torch.zeros(stack + (batch, cfg.ssm_conv_width - 1, conv_dim),
                            dtype=dtype, device=device),
        "ssm": torch.zeros(stack + (batch, H, N, cfg.ssm_head_dim),
                           dtype=dtype, device=device),
    }


def decode_mamba(p, x: torch.Tensor, cfg: ModelConfig, cache,
                 d_inner: Optional[int] = None):
    """One-token mamba step.  x: (B, 1, d).  Returns (y (B, 1, d), cache),
    the cache updated in place."""
    Bsz = x.shape[0]
    d_in, H, N, _ = mamba_dims(cfg, d_inner)
    dt_c = x.dtype
    zxbcdt = x[:, 0] @ cast(p["in_proj"], dt_c)              # (B, .)
    z, xBC, dt_raw = _split_proj(zxbcdt, d_in, N, H)

    # conv ring: window = [cache conv, new]
    w = p["conv_w"].float()
    win = torch.cat([cache["conv"].float(), xBC.float()[:, None]], dim=1)
    conv = torch.einsum("bwc,wc->bc", win, w) + p["conv_b"].float()
    xBC_c = F.silu(conv)

    xs = xBC_c[..., :d_in].reshape(Bsz, H, cfg.ssm_head_dim)
    Bm = xBC_c[..., d_in:d_in + N]
    Cm = xBC_c[..., d_in + N:]
    dt, A = _dt_and_a(p, dt_raw)
    y, h_new = ssd_decode_step(cache["ssm"], xs, dt, A, Bm, Cm, p["D"])
    y = y.reshape(Bsz, d_in).float()
    y = _gated_norm(p, y, z, cfg.norm_eps)
    out = (y.to(dt_c) @ cast(p["out_proj"], dt_c))[:, None]
    cache["conv"].copy_(win[:, 1:])
    cache["ssm"].copy_(h_new)
    return out, cache
