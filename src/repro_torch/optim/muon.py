"""Muon — momentum + Newton-Schulz orthogonalisation, nanochat's inner
optimizer for weight matrices (the JAX package's ``optim/muon.py``).

Newton-Schulz is five batched matrix products per step in f32.  The JAX
package has no kernel for it, so here it is plain ``torch.matmul``.
Stacked layer leaves (L, m, n) are orthogonalised per layer by batching
the products over the leading dim; the update scale sqrt(max(1, m/n))
uses the last two dims.
"""
from __future__ import annotations

from typing import Callable, Union

import torch

from repro_torch.optim.base import Optimizer

_NS_COEFFS = (3.4445, -4.7750, 2.0315)


def newton_schulz(G: torch.Tensor, steps: int = 5,
                  eps: float = 1e-7) -> torch.Tensor:
    """Approximate orthogonalisation of the last two dims (quintic NS)."""
    a, b, c = _NS_COEFFS
    X = G.float()
    transposed = X.shape[-2] > X.shape[-1]
    if transposed:
        X = X.mT
    norm = torch.sqrt(X.square().sum(dim=(-2, -1), keepdim=True))
    X = X / (norm + eps)
    for _ in range(steps):
        A = X @ X.mT
        B = b * A + c * (A @ A)
        X = a * X + B @ X
    return X.mT if transposed else X


def muon(lr: Union[float, Callable] = 0.02, momentum: float = 0.95,
         ns_steps: int = 5, nesterov: bool = True) -> Optimizer:
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params):
        return {"mu": {k: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device)
                       for k, p in params.items()}}

    @torch.no_grad()
    def update(grads, state, params, step):
        lr_t = torch.as_tensor(lr_fn(step), dtype=torch.float32,
                               device=step.device)
        updates, mu_new = {}, {}
        for k, g in grads.items():
            if g.dim() < 2:
                raise ValueError(f"muon got a {g.dim()}-d leaf {k!r}: "
                                 f"partition_label sends it to adamw")
            g = g.float()
            mu = momentum * state["mu"][k] + g
            eff = g + momentum * mu if nesterov else mu
            o = newton_schulz(eff, ns_steps)
            m, n = o.shape[-2], o.shape[-1]
            scale = torch.sqrt(torch.tensor(max(1.0, m / n),
                                            dtype=torch.float32,
                                            device=o.device))
            updates[k], mu_new[k] = -lr_t * scale * o, mu
        return updates, {"mu": mu_new}

    return Optimizer(init, update)
