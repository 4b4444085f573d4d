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
the backward uses to recompute the probabilities.

``flash_attention_fp8_plain`` is the plain version of the ``fp8=True``
forward (QK^T on per-row fp8_e4m3 codes): the JAX oracle
``reference_attention_fp8``.

``tf32_round`` and ``split_tf32`` are the CUDA kernels' operand split
(hi = TF32 of x, lo = TF32 of x - hi), for tests of its numerics on the
CPU; no plain version uses them."""
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


def flash_attention_fp8_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, causal: bool = True,
                              window: Optional[int] = None):
    """The ``fp8=True`` forward: every (position, head) row of q and k is
    quantized to fp8_e4m3 under its own amax scale over D
    (``quantize_axis``), dequantized (back to the input's dtype, as the
    oracle does), and the exact attention runs on the result.  Returns
    (o, lse) as :func:`flash_attention_plain`."""
    from repro_torch.kernels.quantize.ref import quantize_axis

    def dq(x):
        xq, s = quantize_axis(x, -1, "fp8_e4m3")
        return (xq.float() * s).to(x.dtype)

    return flash_attention_plain(dq(q), dq(k), v, causal, window)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32 as ``cvt.rna.tf32.f32`` rounds: to
    nearest on the low 13 bits of the significand, ties away from zero
    (half a TF32 ulp added to the magnitude bits, then the low 13 bits
    cleared: a carry moves into the exponent, the largest finite values
    become inf); NaN stays NaN."""
    x = x.float().contiguous()
    bits = x.view(torch.int32).to(torch.int64)
    r = (bits + 0x1000) & 0xFFFFE000
    r = torch.where(r >= 2 ** 31, r - 2 ** 32, r).to(torch.int32)
    return torch.where(torch.isnan(x), x, r.view(torch.float32))


def split_tf32(x: torch.Tensor):
    """(hi, lo) TF32 parts of float32 ``x``: hi = tf32_round(x), lo =
    tf32_round(x - hi) (x - hi is exact in f32), so hi + lo is x to within
    2^-22 |x|."""
    hi = tf32_round(x)
    return hi, tf32_round(x.float() - hi)
