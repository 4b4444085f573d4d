#!/usr/bin/env python3
"""Where the f32 flash backward's error against float64 comes from.

    python3 tools/flash_bwd_error_probe.py [--out FILE]

Run from the root of a checkout on a machine with an NVIDIA GPU and nvcc.
At each shape of ``CASES`` (causal, f32, seeded as ``chip_smoke.py``'s
``flash_inputs``) it takes dq, dk, dv against a float64 autograd of the
same attention and reports each gradient's max error for:

- ``kernel``: ``flash_bwd`` from the kernel forward's o and lse;
- ``plain``: autograd through the plain f32 forward (the smoke's gate
  divides by this one);
- ``plain_bwd``: the plain backward formula in f32 from the kernel's o
  and lse (what the forward's state alone costs);
- ``split_fma``: the kernel's arithmetic with every product's operands
  split into TF32 (hi, lo) parts and the three terms summed by f32
  matrix products (round to nearest, cuBLAS order);
- ``split_mma_rn`` / ``split_mma_rz``: the same operands, with the last
  product of each gradient (dS.K, dS^T.Q, P^T.dO) accumulated as the
  kernel does: in k-steps of 8 in its reduction order (the group's heads
  outer, then the queries, for dK/dV; the keys for dQ), each step's three
  ``mma.sync`` terms (hi.lo, lo.hi, hi.hi) one after another, each term
  added exactly and the sum rounded to f32 to nearest (rn) or toward
  zero (rz).

and ``bias``: mean(sign(ref) (x - ref)) / mean(|x - ref|) over each
gradient, -1 when every error points toward zero.  Prints one JSON line
per case, then the card's name and power limit; ``--out`` writes the
list as JSON.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# (B, S, H, KV, D, window): the smoke's gated training shape (phase 2)
# and the long-sequence shapes of the decoder-only configs
CASES = ((4, 1024, 10, 10, 128, 0), (2, 256, 32, 8, 128, 4096),
         (1, 1280, 25, 5, 64, 1024), (1, 1280, 25, 5, 64, 0),
         (1, 4352, 32, 8, 128, 4096), (1, 1024, 40, 8, 128, 8192))
KSTEP = 8        # m16n8k8: the reduction advances 8 at a time


def split(torch, x):
    """(hi, lo) TF32 parts as the kernel's ``split`` takes them."""
    from repro_torch.kernels.flash_attention.ref import tf32_round
    hi = tf32_round(x)
    return hi, tf32_round(x - hi)


def mm3(torch, eq, a, b):
    """einsum ``eq`` with the split products, f32 sums (small terms
    first, as ``mma_split``)."""
    (ah, al), (bh, bl) = split(torch, a), split(torch, b)
    return (torch.einsum(eq, ah, bl) + torch.einsum(eq, al, bh)) \
        + torch.einsum(eq, ah, bh)


def round_f32(torch, x, rz):
    r = x.float()
    if rz:
        over = r.double().abs() > x.abs()
        r = torch.where(over, torch.nextafter(r, torch.zeros_like(r)), r)
    return r


def mma_accumulate(torch, a, b, rz):
    """sum_r a[..., r, n] b[..., r, d] over r in k-steps of ``KSTEP``,
    each step's three split terms added to the f32 accumulator one at a
    time (the step's products summed exactly, then rounded)."""
    (ah, al), (bh, bl) = split(torch, a), split(torch, b)
    c = torch.zeros(a.shape[:-2] + (a.shape[-1], b.shape[-1]),
                    dtype=torch.float32, device=a.device)
    for r0 in range(0, a.shape[-2], KSTEP):
        sl = slice(r0, r0 + KSTEP)
        for x, y in ((ah, bl), (al, bh), (ah, bh)):
            part = x[..., sl, :].double().transpose(-1, -2) \
                @ y[..., sl, :].double()
            c = round_f32(torch, c.double() + part, rz)
    return c


def f64_grads(torch, q, k, v, do, window):
    """dq, dk, dv by autograd through float64 masked attention."""
    B, S, H, D = q.shape
    G = H // k.shape[2]
    leaves = [t.double().requires_grad_() for t in (q, k, v)]
    qh, kh, vh = (t.transpose(1, 2) for t in leaves)
    kh, vh = (t.repeat_interleave(G, dim=1) for t in (kh, vh))
    i = torch.arange(S, device=q.device)
    ok = i[None, :] <= i[:, None]
    if window:
        ok &= i[:, None] - i[None, :] < window
    s = (qh @ kh.transpose(-1, -2)) / math.sqrt(D)
    s = s.masked_fill(~ok, float("-inf"))
    o = torch.softmax(s, dim=-1) @ vh
    return [g.detach() for g in torch.autograd.grad(
        o.transpose(1, 2), leaves, do.double())]


def split_models(torch, q, k, v, o, lse, do, window):
    """{"split_fma" / "split_mma_rn" / "split_mma_rz": (dq, dk, dv)} from
    the kernel forward's o and lse."""
    B, S, H, D = q.shape
    KV = k.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(D)
    qg, dog, og = (t.reshape(B, S, KV, G, D).permute(0, 2, 3, 1, 4)
                   for t in (q, do, o))                   # (B, KV, G, S, D)
    kk, vv = (t.permute(0, 2, 1, 3) for t in (k, v))      # (B, KV, S, D)
    i = torch.arange(S, device=q.device)
    ok = i[None, :] <= i[:, None]
    if window:
        ok &= i[:, None] - i[None, :] < window
    s = mm3(torch, "bkgqd,bksd->bkgqs", qg, kk) * scale
    s = s.masked_fill(~ok, float("-inf"))
    p = torch.exp(s - lse.reshape(B, KV, G, S, 1))
    del s
    delta = (dog * og).sum(-1, keepdim=True)
    ds = p * (mm3(torch, "bkgqd,bksd->bkgqs", dog, vv) - delta)
    out = {"split_fma": (
        mm3(torch, "bkgqs,bksd->bkgqd", ds, kk) * scale,
        mm3(torch, "bkgqs,bkgqd->bksd", ds, qg) * scale,
        mm3(torch, "bkgqs,bkgqd->bksd", p, dog))}
    R = G * S
    for name, rz in (("split_mma_rn", False), ("split_mma_rz", True)):
        dq = mma_accumulate(torch, ds.transpose(-1, -2),
                            kk[:, :, None].expand(B, KV, G, S, D), rz) * scale
        dk = mma_accumulate(torch, ds.reshape(B, KV, R, S),
                            qg.reshape(B, KV, R, D), rz) * scale
        dv = mma_accumulate(torch, p.reshape(B, KV, R, S),
                            dog.reshape(B, KV, R, D), rz)
        out[name] = (dq, dk, dv)
    back = lambda t: t.permute(0, 3, 1, 2, 4).reshape(B, S, H, D)
    return {n: (back(dq), dk.permute(0, 2, 1, 3), dv.permute(0, 2, 1, 3))
            for n, (dq, dk, dv) in out.items()}


def probe(torch, shape, seed):
    from chip_smoke import flash_inputs
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd_plain, flash_attention_plain, flash_bwd,
        flash_fwd)
    B, S, H, KV, D, window = shape
    window = window or None
    q, k, v, do = flash_inputs(torch, B=B, S=S, H=H, KV=KV, D=D, seed=seed)
    ref = f64_grads(torch, q, k, v, do, window)
    o, lse = flash_fwd(q, k, v, window=window)
    runs = {"kernel": flash_bwd(q, k, v, o, lse, do, window=window)}
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    o_ref, _ = flash_attention_plain(*leaves, True, window)
    runs["plain"] = torch.autograd.grad(o_ref, leaves, do)
    del leaves, o_ref
    runs["plain_bwd"] = flash_attention_bwd_plain(q, k, v, o, lse, do, True,
                                                  window)
    runs.update(split_models(torch, q, k, v, o, lse, do, window))
    rec = {"shape": shape, "errors": {}, "bias": {}}
    for name, grads in runs.items():
        errs, bias = {}, {}
        for g, x, r in zip(("dq", "dk", "dv"), grads, ref):
            e = x.double() - r
            errs[g] = float(e.abs().max())
            bias[g] = float((torch.sign(r) * e).mean() / e.abs().mean())
        rec["errors"][name], rec["bias"][name] = errs, bias
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("flash_bwd_error_probe: CUDA is not available",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from chip_smoke import gpu_line
    from repro_torch.kernels import _build
    _build.build()
    recs = []
    for n, shape in enumerate(CASES):
        rec = probe(torch, shape, seed=n)
        recs.append(rec)
        print(json.dumps(rec), flush=True)
        torch.cuda.empty_cache()
    print(gpu_line())
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(recs, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
