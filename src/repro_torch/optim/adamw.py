"""AdamW — the inner optimizer for embeddings / unembedding / norms in
nanochat's split (the JAX package's ``optim/adamw.py``).

``fused=True`` sends each leaf through the fused AdamW kernel
(``repro_torch.kernels.fused_adamw``: the CUDA kernel on the card, its
plain version on the CPU): both moment updates, the bias corrections,
weight decay and the scaled update in one pass.  The unfused path runs
the same f32 operations in the same order as separate PyTorch ops.

The moments are updated in place: the state given to ``update`` is
consumed (as Muon's momentum is), so a worker holds one copy of them
and no second one builds up over its leaves while it steps."""
from __future__ import annotations

from typing import Callable, Tuple, Union

import torch

from repro_torch.kernels.fused_adamw import fused_adamw_update
from repro_torch.optim.base import Optimizer


def adamw(lr: Union[float, Callable] = 3e-4,
          betas: Tuple[float, float] = (0.9, 0.95),
          eps: float = 1e-10,
          weight_decay: float = 0.0,
          fused: bool = False) -> Optimizer:
    b1, b2 = betas
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params):
        return {"m": {k: torch.zeros(p.shape, dtype=torch.float32,
                                     device=p.device)
                      for k, p in params.items()},
                "v": {k: torch.zeros(p.shape, dtype=torch.float32,
                                     device=p.device)
                      for k, p in params.items()}}

    @torch.no_grad()
    def update(grads, state, params, step):
        t = step.float() + 1.0
        lr_t = torch.as_tensor(lr_fn(step), dtype=torch.float32,
                               device=step.device)
        bc1, bc2 = 1 - b1 ** t, 1 - b2 ** t
        updates, m_new, v_new = {}, {}, {}
        for k, g in grads.items():
            m, v, p = state["m"][k], state["v"][k], params[k]
            if fused:
                u, m_k, v_k = fused_adamw_update(p, g, m, v, lr_t, bc1, bc2,
                                                 b1=b1, b2=b2, eps=eps,
                                                 wd=weight_decay)
                m.copy_(m_k)
                v.copy_(v_k)
                del m_k, v_k
            else:
                # in place: the same roundings as b1 * m + (1 - b1) * g
                g = g.float()
                m.mul_(b1).add_((1 - b1) * g)
                v.mul_(b2).add_((1 - b2) * g.square())
                mhat = m / bc1
                vhat = v / bc2
                u = -lr_t * (mhat / (torch.sqrt(vhat) + eps)
                             + weight_decay * p.float())
            updates[k], m_new[k], v_new[k] = u, m, v
        return updates, {"m": m_new, "v": v_new}

    return Optimizer(init, update)
