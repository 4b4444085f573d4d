"""Plain PyTorch version of the fused AdamW kernel: the CPU path of the
wrapper in ``ops.py`` and the yardstick the CUDA kernel is held to.

The same per-leaf math as the JAX package's ``kernels/fused_adamw/ref.py``
``reference_fused_adamw`` (and its unfused ``optim/adamw.py``), the same
operations on f32 intermediates in the same order.  The bias corrections
``bc1 = 1 - b1**t`` / ``bc2 = 1 - b2**t`` and ``lr`` are f32 scalars the
caller computes per step."""
from __future__ import annotations

import torch


def fused_adamw_plain(p, g, m, v, lr, bc1, bc2, *, b1: float, b2: float,
                      eps: float, wd: float):
    """One AdamW step on one leaf: p/g any float dtype, m/v f32, lr/bc1/bc2
    f32 0-d tensors.  Returns (update, new_m, new_v), all f32."""
    g = g.float()
    m = b1 * m + (1 - b1) * g
    v = b2 * v + (1 - b2) * g.square()
    mhat = m / bc1
    vhat = v / bc2
    u = -lr * (mhat / (torch.sqrt(vhat) + eps) + wd * p.float())
    return u, m, v
