"""Core layers of the dense decoder: norms, rotary embeddings, embedding /
unembedding, the SwiGLU MLP and the cross-entropy loss, as plain
functions on tensors.

Parameters are nested dicts of tensors with the JAX package's layout:
matrices are ``(d_in, d_out)`` and applied as ``x @ W``; norms carry a
float32 ``scale``.  Norms go through the RMSNorm kernels
(``repro_torch.kernels.rmsnorm``): the CUDA kernel for CUDA tensors, its
plain version for CPU tensors; both are differentiable, with a backward
kernel of their own.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_residual

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    """``ModelConfig`` dtype name -> torch dtype."""
    if name not in _DTYPES:
        raise NotImplementedError(f"dtype {name!r}: the port runs float32 "
                                  f"or bfloat16")
    return _DTYPES[name]


def cast(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``w`` in ``dtype``, without a copy when it already is."""
    return w if w.dtype == dtype else w.to(dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def _require_rmsnorm(cfg: ModelConfig) -> None:
    if cfg.norm != "rmsnorm":
        raise NotImplementedError(f"norm {cfg.norm!r}: the port has the "
                                  f"RMSNorm kernel only")


def apply_norm(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    _require_rmsnorm(cfg)
    return rmsnorm(x, p["scale"], eps=cfg.norm_eps)


def apply_norm_residual(p, x: torch.Tensor, residual: torch.Tensor,
                        cfg: ModelConfig):
    """``h = residual + x; return norm(h), h`` in one kernel."""
    _require_rmsnorm(cfg)
    return rmsnorm_residual(x, residual, p["scale"], eps=cfg.norm_eps)


# ---------------------------------------------------------------------------
# Rotary position embeddings (split-half convention, f32 angles)
# ---------------------------------------------------------------------------

def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float):
    """cos/sin tables for ``positions`` (..., S): each (..., S, 1, D/2)
    f32, broadcasting over heads.  Computed once per forward and shared
    by every layer."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=positions.device) / head_dim
    angles = positions[..., None, None].float() * (1.0 / (theta ** exps))
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: (..., S, H, D) rotated by split halves [x1, x2]."""
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------

def embed(p, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return F.embedding(tokens.long(), p["table"]).to(
        torch_dtype(cfg.compute_dtype))


def token_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for a serving forward's (S, T, d) rows as one (S, d) GEMM
    per token column, so a verify forward (T > 1) runs exactly the GEMM a
    decode forward (T = 1) runs and each row comes out the same to the
    bit.  cuBLAS picks its kernel, and with it the summation order, by
    the number of rows (and a batched GEMM by the batch count)."""
    if x.shape[1] == 1:
        return x @ w
    xt = x.transpose(0, 1).contiguous()
    return torch.stack([xt[t] @ w for t in range(xt.shape[0])], dim=1)


def unembed(p, h: torch.Tensor, cfg: ModelConfig,
            mm=torch.matmul) -> torch.Tensor:
    w = p["table"].t() if cfg.tie_embeddings else p["unembed"]
    logits = mm(h, cast(w, h.dtype))
    if cfg.logit_soft_cap > 0:
        logits = cfg.logit_soft_cap * torch.tanh(logits / cfg.logit_soft_cap)
    return logits


# ---------------------------------------------------------------------------
# Dense MLP
# ---------------------------------------------------------------------------

def apply_mlp(p, x: torch.Tensor, cfg: ModelConfig,
              mm=torch.matmul) -> torch.Tensor:
    """SwiGLU; ``mm`` is the matrix product (``attention.serving_matmul``
    when serving)."""
    if cfg.mlp_activation != "swiglu":
        raise NotImplementedError(f"mlp_activation {cfg.mlp_activation!r}: "
                                  f"the port has swiglu only")
    dt = x.dtype
    up = mm(x, cast(p["w_up"], dt))
    gate = mm(x, cast(p["w_gate"], dt))
    return mm(F.silu(gate) * up, cast(p["w_down"], dt))


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------

def softmax_ce_sums(logits: torch.Tensor, labels: torch.Tensor, mask=None,
                    z_loss: float = 0.0):
    """(sum of CE over valid positions, count of valid positions), in f32;
    labels == -1 (and mask == 0) are not valid."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1,
                        labels.long().clamp(min=0)[..., None])[..., 0]
    ce = lse - gold
    if z_loss:
        ce = ce + z_loss * lse.square()
    valid = labels >= 0
    if mask is not None:
        valid = valid & (mask > 0)
    valid = valid.float()
    return (ce * valid).sum(), valid.sum()


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          mask=None, z_loss: float = 0.0) -> torch.Tensor:
    """Mean CE over valid positions, in f32.  labels == -1 are ignored."""
    total, count = softmax_ce_sums(logits, labels, mask, z_loss)
    return total / count.clamp(min=1.0)
