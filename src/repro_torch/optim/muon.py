"""Muon — momentum + Newton-Schulz orthogonalisation, nanochat's inner
optimizer for weight matrices (the JAX package's ``optim/muon.py``).

Newton-Schulz is five batched matrix products per step in f32.  The JAX
package has no kernel for it, so here it is plain ``torch.matmul``.
``update`` consumes its state: the momentum buffers are updated in place
and returned in the new state.
Stacked layer leaves (L, m, n) are orthogonalised per layer by batching
the products over the leading dim; the update scale sqrt(max(1, m/n))
uses the last two dims.

With a model ``axis`` (``optim/base.py``) a leaf split over it is
orthogonalised WHOLE, as the reference's SPMD computes it on the
logical matrix: the effective update is all-gathered over the model
group along the split dim, Newton-Schulz and the scale run on the whole
matrix (the norm, X·Xᵀ, the transpose choice and m/n are the whole
matrix's), and each rank keeps its slice.  Every model rank computes
the same iteration.  Under ``fsdp`` (an ``axis`` whose data axis splits
the leaves) the effective update is all-gathered over the data group
along its ``fsdp`` dim as well, so every rank of a worker
orthogonalises the whole matrix and keeps its piece.
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
         ns_steps: int = 5, nesterov: bool = True, axis=None) -> Optimizer:
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
            # in place: the same two roundings as momentum * mu + g, and
            # no second copy of the momentum (the old state is consumed)
            mu = state["mu"][k].mul_(momentum).add_(g)
            eff = g + momentum * mu if nesterov else mu
            dim = ddim = None
            if axis is not None:
                dim, ddim = axis.split_dim(k), axis.data_split_dim(k)
            if dim is not None:
                eff = axis.model_all_gather(eff, dim)
            if ddim is not None:
                eff = axis.data_all_gather(eff, ddim)
            o = newton_schulz(eff, ns_steps)
            m, n = o.shape[-2], o.shape[-1]
            scale = torch.sqrt(torch.tensor(max(1.0, m / n),
                                            dtype=torch.float32,
                                            device=o.device))
            if ddim is not None:
                o = axis.data_part(o, ddim)
            if dim is not None:
                o = axis.model_part(o, dim)
            updates[k], mu_new[k] = -lr_t * scale * o, mu
        return updates, {"mu": mu_new}

    return Optimizer(init, update)
