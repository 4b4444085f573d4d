"""SSD chunk-scan wrapper: the hand-written CUDA kernel (``csrc/ssd.cu``)
for CUDA tensors, the plain ``ssd_chunked`` (``ref.py``) for CPU tensors.

Shapes as in ``ref.py``: x (B, S, H, P) float32 or bfloat16, dt (B, S,
H), A and D (H,), Bm / Cm (B, S, N).  The chunk follows the JAX
package's wrapper (``repro/kernels/ssd/ops.py``): Q = min(chunk, S) if
S % chunk else chunk, and S is padded to a multiple of Q with dt = 0
(decay 1, zero input: a no-op for the recurrence) and stripped again.
The kernel takes the padding as rows it loads as zeros and never
writes, so no padded copy is made.  Returns (y in x's dtype (B, S, H, P),
final state h float32 (B, H, N, P)).

The kernel runs the state-passing decomposition (``csrc/ssd.cu``): the
wrapper allocates its scratch with ``torch.empty`` (the chunk states
(B, nc, H, N, P), the chunk cumsums (B, nc, H, Q) and C.B^T (B, nc, Q,
Q), f32, nc = ceil(S / Q)); the kernels allocate nothing.

The kernel has no backward: on the card the scan serves the forward
(scoring, prefill) only, and a call on tensors that require grad raises
(the plain version on the CPU is differentiable through autograd).

Launch count: ``ssd``, one per call of ``ssd`` on the card, which makes
four device launches (C.B^T, the chunk states, the state passing, the
chunk scan), each checked for a launch error."""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ssd.ref import ssd_chunked

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # x_dtype, x, dt, A, Bm, Cm, D, y, h, st, cum, cb, B, S, H, P, N, Q,
    # stream
    "repro_ssd": (_I,) + (_P,) * 11 + (_I,) * 6 + (_P,),
}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_CHUNK = 128


def chunk_len(S: int, chunk: int) -> int:
    """The chunk the scan runs at for a sequence of S tokens."""
    return min(chunk, S) if S % chunk else chunk


def _check(x, dt, A, Bm, Cm, D, Q):
    if x.device.type != "cuda":
        raise ValueError(f"ssd takes CPU or CUDA tensors, got {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"ssd kernel takes float32 or bfloat16 x, got "
                        f"{x.dtype}")
    if any(t.requires_grad for t in (x, dt, A, Bm, Cm, D)):
        raise NotImplementedError(
            "the SSD kernel has no backward (SSM training is not ported)")
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    want = {"dt": (dt, (Bsz, S, H)), "A": (A, (H,)), "D": (D, (H,)),
            "Bm": (Bm, (Bsz, S, N)), "Cm": (Cm, (Bsz, S, N))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if t.device != x.device:
            raise ValueError("ssd operands must share one device")
    if not 1 <= Q <= MAX_CHUNK:
        raise ValueError(f"ssd kernel takes chunks of 1..{MAX_CHUNK} tokens, "
                         f"got {Q}")


def ssd(x, dt, A, Bm, Cm, D, *,
        chunk: int = 128) -> Tuple[torch.Tensor, torch.Tensor]:
    if x.device.type == "cpu":
        return ssd_chunked(x, dt, A, Bm, Cm, D, chunk)
    if x.dim() != 4:
        raise ValueError("x must be (B, S, H, P)")
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    Q = chunk_len(S, chunk)
    _check(x, dt, A, Bm, Cm, D, Q)
    x = x.contiguous()
    dt, A, Bm, Cm, D = (t.float().contiguous() for t in (dt, A, Bm, Cm, D))
    y = torch.empty_like(x)
    f32 = dict(dtype=torch.float32, device=x.device)
    nc = -(-S // Q)
    h = torch.empty((Bsz, H, N, P), **f32)
    st = torch.empty((Bsz, nc, H, N, P), **f32)
    cum = torch.empty((Bsz, nc, H, Q), **f32)
    cb = torch.empty((Bsz, nc, Q, Q), **f32)
    lib = _build.load("ssd", _SIGNATURES)
    with torch.cuda.device(x.device):
        rc = lib.repro_ssd(
            _DTYPES[x.dtype], x.data_ptr(), dt.data_ptr(), A.data_ptr(),
            Bm.data_ptr(), Cm.data_ptr(), D.data_ptr(), y.data_ptr(),
            h.data_ptr(), st.data_ptr(), cum.data_ptr(), cb.data_ptr(),
            Bsz, S, H, P, N, Q,
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, lib, "ssd")
    _build.launches["ssd"] += 1
    return y, h
