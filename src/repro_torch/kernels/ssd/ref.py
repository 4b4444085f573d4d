"""Plain PyTorch versions of the Mamba-2 SSD scan: the CPU path of the
wrapper in ``ops.py`` and the yardstick the CUDA kernel is held to.

``ssd_chunked`` is a line-for-line copy of the JAX package's
``repro.models.ssm.ssd_chunked`` (the Pallas kernel's own oracle), in
float32 throughout, but for one line: the intra-chunk decays mask the
exponent before the exp, not the exp after it, which gives the same
values and keeps the gradient finite where the reference's is NaN: the sequence is cut into chunks of Q tokens; an
intra-chunk quadratic term (a causal (Q x Q) decay-weighted product) plus
an inter-chunk linear recurrence over per-chunk states.
``ssd_decode_step`` is the one-token recurrence the decode path runs.
``ssd_state_passing`` is the CUDA kernel's design in plain tensor code
(``csrc/ssd.cu``): chunk states, state passing, C.B^T once per chunk and
the chunk scan, every product in k-steps of 8 as the kernel's mma.sync
takes them, optionally on operands split into TF32 hi and lo parts as the
kernel splits them (``split_tf32``: three products, small terms first).

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
K_STEP = 8             # the k of one mma.sync m16n8k8 product


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
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    # exp of the masked difference (exp(-inf) = 0): the reference masks
    # after the exp, where the upper triangle's positive exponents
    # overflow once a chunk's decay passes e^88, and the backward's
    # 0 x inf makes dt's and A's gradients NaN; the values are the same
    L = torch.exp(torch.where(mask, cumT[..., :, None] - cumT[..., None, :],
                              torch.full((), float("-inf"),
                                         device=x.device)))
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


# ---------------------------------------------------------------------------
# The CUDA kernel's design, in plain tensor code
# ---------------------------------------------------------------------------

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


def _ksteps(acc, a, b, k_real: int, split: bool, fresh: bool = False):
    """acc + a @ b (batched over the leading dims), the k index (a's last,
    b's second to last) in steps of ``K_STEP`` in order, each step's
    product added to ``acc`` as one mma.sync adds it; steps that start at
    or past ``k_real`` (all-zero rows) are skipped.  ``split``: each step
    as the three TF32 products hi.lo, lo.hi, hi.hi, in that order.
    ``fresh``: each step's products summed from zero, then added to acc
    (the kernel's C.B^T)."""
    for k0 in range(0, min(a.shape[-1], k_real), K_STEP):
        ak, bk = a[..., k0:k0 + K_STEP], b[..., k0:k0 + K_STEP, :]
        part = torch.zeros_like(acc) if fresh else acc
        if split:
            (ah, al), (bh, bl) = split_tf32(ak), split_tf32(bk)
            part = part + ah @ bl
            part = part + al @ bh
            part = part + ah @ bh
        else:
            part = part + ak @ bk
        acc = acc + part if fresh else part
    return acc


def ssd_state_passing(x, dt, A, Bm, Cm, D, chunk: int, *,
                      split: bool = False, skip_padded: bool = True,
                      parts: bool = False):
    """The chunked SSD scan as ``csrc/ssd.cu`` computes it.  Per chunk c of
    Q rows (r of them real):
      1. cum, the chunk cumsum of dt*A (``chunk_cumsum``: the plain
         version's bits), w_j = dt_j exp(cum_last - cum_j), and the chunk
         state S_c = B^T (w x), its operand B_j w_j;
      2. state passing: h_prev[c] = h, h = exp(cum_last) h + S_c;
      3. C.B^T once per (batch row, chunk), shared by every head, each
         k-step's products summed from zero before they are added;
      4. the chunk scan: y = exp(cum_i) (C . h_prev[c]) + ((C.B^T) o L o
         dt_j + D I) . x, L_ij = exp(cum_i - cum_j) where j <= i, else 0:
         the skip D x rides on the intra product's diagonal.
    ``skip_padded``: k-steps past the chunk's real rows, and chunk 0's
    C . h_prev (h_prev = 0), are skipped as the kernel skips them (they add
    exact zeros).  ``split``: products on split TF32 operands.  Returns
    (y in x's dtype, final state f32), and with ``parts`` also a dict of
    the intermediates: cum (B, nc, Q, H), w (B, nc, H, Q), states (B, nc,
    H, N, P) (the state before each chunk), cb (B, nc, Q, Q)."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    pad = (-S) % Q
    nc = (S + pad) // Q
    xc = F.pad(x.float(), (0, 0, 0, 0, 0, pad)).reshape(Bsz, nc, Q, H, P)
    dtc = F.pad(dt.float(), (0, 0, 0, pad)).reshape(Bsz, nc, Q, H)
    Bc = F.pad(Bm.float(), (0, 0, 0, pad)).reshape(Bsz, nc, Q, N)
    Cc = F.pad(Cm.float(), (0, 0, 0, pad)).reshape(Bsz, nc, Q, N)
    cum = chunk_cumsum(dtc * A.float(), dim=2)    # (B,nc,Q,H)
    cumT = cum.permute(0, 1, 3, 2)                # (B,nc,H,Q)
    dtT = dtc.permute(0, 1, 3, 2)
    w = dtT * torch.exp(cumT[..., -1:] - cumT)
    xT = xc.permute(0, 1, 3, 2, 4)                # (B,nc,H,Q,P)
    real = [min(Q, S - c * Q) if skip_padded else Q for c in range(nc)]
    zeros = x.new_zeros
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))

    eye = torch.eye(Q, device=x.device)
    S_c, cb = [], []
    for c in range(nc):
        bw = (Bc[:, c, None] * w[:, c, ..., None]).transpose(-1, -2)
        S_c.append(_ksteps(zeros((Bsz, H, N, P), dtype=torch.float32), bw,
                           xT[:, c], real[c], split))
        cb.append(_ksteps(zeros((Bsz, Q, Q), dtype=torch.float32), Cc[:, c],
                          Bc[:, c].transpose(-1, -2), N, split, fresh=True))

    h = zeros((Bsz, H, N, P), dtype=torch.float32)
    h_prev = []
    for c in range(nc):
        h_prev.append(h)
        h = torch.exp(cumT[:, c, :, -1])[..., None, None] * h + S_c[c]

    ys = []
    for c in range(nc):
        acc = zeros((Bsz, H, Q, P), dtype=torch.float32)
        if c > 0 or not skip_padded:
            acc = _ksteps(acc, Cc[:, c, None], h_prev[c], N, split)
            acc = acc * torch.exp(cumT[:, c])[..., None]
        ct = cumT[:, c]                           # L only where j <= i
        L = torch.exp(ct[..., :, None] - ct[..., None, :])
        M = torch.where(mask, cb[c][:, None] * L * dtT[:, c, :, None, :],
                        torch.zeros((), device=x.device))
        M = M + eye * D.float()[None, :, None, None]
        acc = _ksteps(acc, M, xT[:, c], real[c], split)
        ys.append(acc.permute(0, 2, 1, 3))        # (B,Q,H,P)
    y = torch.stack(ys, 1).reshape(Bsz, nc * Q, H, P)[:, :S].to(x.dtype)
    if not parts:
        return y, h
    return y, h, {"cum": cum, "w": w, "states": torch.stack(h_prev, 1),
                  "cb": torch.stack(cb, 1)}
