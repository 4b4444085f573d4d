"""Plain PyTorch versions of the flash attention kernels: the CPU path of
the wrappers in ``ops.py`` and the yardstick the CUDA kernels are held to.

The function is the JAX package's ``kernels/flash_attention/kernel.py``
``flash_attention_fwd`` (and its jnp oracle ``ref.py``
``reference_attention``): causal softmax attention with an optional
window, scale 1/sqrt(D), computed in f32, grouped-query.  The layout here
is the model's: q (B, S, H, D), k/v (B, S, KV, D), H % KV == 0 — the JAX
kernel takes (B, H, S, D), a transpose away.  Scores are materialised
(B, KV, G, S, S); masked scores are the JAX code's finite -1e30, so their
probabilities are exactly 0 and no row (every row sees its own key) is
empty.  The forward also returns the row log-sum-exp (B, H, S) f32, which
the backward uses to recompute the probabilities."""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def _mask(S: int, causal: bool, window: Optional[int],
          device) -> torch.Tensor:
    """(S, S) bool: query row i may see key column j."""
    pos = torch.arange(S, device=device)
    diff = pos[:, None] - pos[None, :]
    ok = torch.ones((S, S), dtype=torch.bool, device=device)
    if causal:
        ok &= diff >= 0
    if window:
        ok &= diff < window
    return ok


def _scores(q, k, causal, window):
    """f32 masked scores (B, KV, G, S, S) and the f32 grouped q, k."""
    B, S, H, D = q.shape
    KV = k.shape[2]
    qf = q.float().reshape(B, S, KV, H // KV, D)
    kf = k.float()
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, kf) / math.sqrt(D)
    s = torch.where(_mask(S, causal, window, q.device), s,
                    torch.full_like(s, NEG_INF))
    return s, qf, kf


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True,
                          window: Optional[int] = None):
    """Returns (o (B, S, H, D) in q's dtype, lse (B, H, S) f32)."""
    B, S, H, D = q.shape
    s, _, _ = _scores(q, k, causal, window)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bkgqs,bskd->bqkgd", p / l, v.float())
    lse = (m + torch.log(l)).reshape(B, H, S)
    return o.reshape(B, S, H, D).to(q.dtype).contiguous(), lse


def flash_attention_bwd_plain(q, k, v, o, lse, do, causal: bool = True,
                              window: Optional[int] = None):
    """Gradients (dq, dk, dv) of :func:`flash_attention_plain`'s output,
    each in its input's dtype, from the saved output ``o`` and ``lse``:
    P = exp(s - lse) recomputed, delta = rowsum(dO * O),
    dS = P * (dO V^T - delta), dQ = dS K / sqrt(D), dK = dS^T Q / sqrt(D),
    dV = P^T dO, summed over the G query heads of each KV head."""
    B, S, H, D = q.shape
    KV = k.shape[2]
    G = H // KV
    s, qf, kf = _scores(q, k, causal, window)
    p = torch.exp(s - lse.reshape(B, KV, G, S, 1))
    dof = do.float().reshape(B, S, KV, G, D)
    delta = (dof * o.float().reshape(B, S, KV, G, D)).sum(dim=-1)
    dv = torch.einsum("bkgqs,bqkgd->bskd", p, dof)
    dp = torch.einsum("bqkgd,bskd->bkgqs", dof, v.float())
    ds = p * (dp - delta.permute(0, 2, 3, 1)[..., None])
    scale = 1.0 / math.sqrt(D)
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, kf) * scale
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds, qf) * scale
    return (dq.reshape(B, S, H, D).to(q.dtype).contiguous(),
            dk.to(k.dtype).contiguous(), dv.to(v.dtype).contiguous())
