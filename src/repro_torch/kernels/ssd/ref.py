"""Plain PyTorch versions of the Mamba-2 SSD scan: the CPU path of the
wrapper in ``ops.py`` and the yardstick the CUDA kernel is held to.

``ssd_chunked`` is a line-for-line copy of the JAX package's
``repro.models.ssm.ssd_chunked`` (the Pallas kernel's own oracle), in
float32 throughout: the sequence is cut into chunks of Q tokens; an
intra-chunk quadratic term (a causal (Q x Q) decay-weighted product) plus
an inter-chunk linear recurrence over per-chunk states.
``ssd_decode_step`` is the one-token recurrence the decode path runs.

The within-chunk cumsum of dt*A (``chunk_cumsum``) keeps the order in
which the JAX package's ``jnp.cumsum`` sums on the CPU (XLA rewrites the
cumulative reduce-window into blocks of 16: a sequential f32 sum inside
each block, then each block's exclusive prefix of block totals added),
so the chunk decays equal the reference's to the bit; ``torch.cumsum``
would sum in another order (in double on the CPU).  The decays are
differences of cumsums that reach about -200 at a 128-token chunk, where
one ulp is about 1e-5, so the order shows in y.  The CUDA kernel sums in
the same order.

Shapes: x (B, S, H, P) heads x head dim, dt (B, S, H) >= 0, A (H,)
negative, Bm / Cm (B, S, N) (one group, as in mamba2-1.3b), D (H,);
the state h is (B, H, N, P).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


CUMSUM_BLOCK = 16


def chunk_cumsum(a: torch.Tensor, dim: int) -> torch.Tensor:
    """Inclusive f32 cumsum along ``dim`` in blocks of ``CUMSUM_BLOCK``:
    sequential within a block, plus the sequential exclusive prefix of the
    block totals."""
    a = a.movedim(dim, -1)
    n = a.shape[-1]
    pad = (-n) % CUMSUM_BLOCK
    ap = F.pad(a, (0, pad)).reshape(*a.shape[:-1], -1, CUMSUM_BLOCK)
    cols = [ap[..., 0]]
    for i in range(1, CUMSUM_BLOCK):
        cols.append(cols[-1] + ap[..., i])
    inner = torch.stack(cols, dim=-1)             # (..., nb, block)
    tot = inner[..., -1]
    pre = [torch.zeros_like(tot[..., 0])]
    for b in range(1, tot.shape[-1]):
        pre.append(pre[-1] + tot[..., b - 1])
    out = inner + torch.stack(pre, dim=-1)[..., None]
    return out.reshape(*a.shape[:-1], -1)[..., :n].movedim(-1, dim)


def ssd_chunked(x, dt, A, Bm, Cm, D, chunk: int,
                h0: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan.  Returns (y in x's dtype, final state f32)."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    x32, dt32 = x.float(), dt.float()
    Bm32, Cm32 = Bm.float(), Cm.float()

    Q = min(chunk, S)
    pad = (-S) % Q
    if pad:
        x32 = F.pad(x32, (0, 0, 0, 0, 0, pad))
        dt32 = F.pad(dt32, (0, 0, 0, pad))
        Bm32 = F.pad(Bm32, (0, 0, 0, pad))
        Cm32 = F.pad(Cm32, (0, 0, 0, pad))
    Sp = S + pad
    nc = Sp // Q

    xc = x32.reshape(Bsz, nc, Q, H, P)
    dtc = dt32.reshape(Bsz, nc, Q, H)
    Bc = Bm32.reshape(Bsz, nc, Q, N)
    Cc = Cm32.reshape(Bsz, nc, Q, N)

    dA = dtc * A.float()                          # (B,nc,Q,H), <= 0
    cum = chunk_cumsum(dA, dim=2)                 # inclusive within-chunk
    xbar = xc * dtc[..., None]

    # intra-chunk: y_i = sum_{j<=i} (C_i.B_j) exp(cum_i - cum_j) xbar_j
    CB = torch.einsum("bnqN,bnkN->bnqk", Cc, Bc)
    cumT = cum.permute(0, 1, 3, 2)                # (B,nc,H,Q)
    L = torch.exp(cumT[..., :, None] - cumT[..., None, :])
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    L = torch.where(mask, L, torch.zeros((), device=x.device))
    M = CB[:, :, None] * L                        # (B,nc,H,Q,Q)
    y_intra = torch.einsum("bnhqk,bnkhp->bnqhp", M, xbar)

    # per-chunk state contribution: S_c = sum_j exp(cum_last - cum_j) B_j xbar_j
    decay_end = torch.exp(cum[:, :, -1:, :] - cum)  # (B,nc,Q,H)
    xbar_dec = xbar * decay_end[..., None]          # (B,nc,Q,H,P)
    S_c = torch.einsum("bnkN,bnkhp->bnhNp", Bc, xbar_dec)

    # inter-chunk recurrence
    chunk_decay = torch.exp(cum[:, :, -1, :])     # (B,nc,H)
    h = (torch.zeros((Bsz, H, N, P), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h)
        h = chunk_decay[:, c, :, None, None] * h + S_c[:, c]
    h_prevs = torch.stack(h_prevs, dim=1)         # (B,nc,H,N,P)

    y_inter = torch.einsum("bnqN,bnhNp->bnqhp", Cc, h_prevs) \
        * torch.exp(cum)[..., None]

    y = (y_intra + y_inter).reshape(Bsz, Sp, H, P)[:, :S]
    y = y + x32[:, :S] * D.float()[None, None, :, None]
    return y.to(x.dtype), h


def ssd_decode_step(h, x, dt, A, Bm, Cm, D):
    """One-token SSD update.  h: (B, H, N, P); x: (B, H, P); dt: (B, H);
    Bm / Cm: (B, N).  Returns (y in x's dtype, h_new f32)."""
    a = torch.exp(dt.float() * A.float())                          # (B,H)
    xbar = x.float() * dt.float()[..., None]                       # (B,H,P)
    h_new = (a[..., None, None] * h.float()
             + torch.einsum("bN,bhp->bhNp", Bm.float(), xbar))
    y = torch.einsum("bN,bhNp->bhp", Cm.float(), h_new)
    y = y + x.float() * D.float()[None, :, None]
    return y.to(x.dtype), h_new
