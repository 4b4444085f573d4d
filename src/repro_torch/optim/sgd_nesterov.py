"""SGD with (Nesterov) momentum — DiLoCo's **outer** optimizer (paper §3:
mu_outer = 0.9, eta_outer = 0.8), the JAX package's ``optim/sgd_nesterov.py``
on flat parameter dicts.  Also usable as a plain inner optimizer.  (The
trainers' outer step is ``core/outer_opt.py``, fused per leaf; this is the
same update as an ``Optimizer``.)"""
from __future__ import annotations

from typing import Callable, Union

import torch

from repro_torch.optim.base import Optimizer


def sgd_nesterov(lr: Union[float, Callable] = 0.8, momentum: float = 0.9,
                 nesterov: bool = True) -> Optimizer:
    """v = momentum v + g; the update is -lr (g + momentum v) (Nesterov)
    or -lr v, in f32.  ``lr``: a number or a function of the step."""
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params):
        return {"v": {k: torch.zeros(p.shape, dtype=torch.float32,
                                     device=p.device)
                      for k, p in params.items()}}

    def update(grads, state, params, step):
        lr_t = lr_fn(step)
        updates, vs = {}, {}
        for k, g in grads.items():
            g = g.float()
            v = momentum * state["v"][k] + g
            eff = g + momentum * v if nesterov else v
            updates[k], vs[k] = -lr_t * eff, v
        return updates, {"v": vs}

    return Optimizer(init, update)
