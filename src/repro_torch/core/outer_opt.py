"""DiLoCo outer synchronization: delta averaging + Nesterov outer SGD
(the JAX package's ``core/outer_opt.py``, plain mean only).

    Δθ_i    = θ_i^H − θ_t          (per-worker parameter delta, f32)
    Δθ̄      = (1/k) Σ_i Δθ_i       (cross-worker average)
    v_{t+1} = μ v_t + Δθ̄
    θ_{t+1} = θ_t + η (Δθ̄ + μ v_{t+1})   (Nesterov; else θ_t + η v_{t+1})

The JAX package ships deltas through a codec transport; its float32 codec
is the identity, and that is the only one ported: any other
``delta_dtype`` raises, as does ``drift_aware`` averaging.  The average is
taken leaf by leaf, so no (K, ...) stack of deltas is ever held.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Tuple

import torch

from repro_torch.configs.base import DiLoCoConfig

Flat = Dict[str, torch.Tensor]

_F32_CODECS = ("float32", "f32")


class OuterState(NamedTuple):
    v: Flat               # outer momentum, f32, one leaf per parameter
    t: torch.Tensor       # outer step counter, 0-d int32


def require_ported(cfg: DiLoCoConfig) -> None:
    """Raise for the outer-sync knobs whose code paths are not ported."""
    if cfg.drift_aware:
        raise NotImplementedError("drift_aware averaging is not ported")
    if cfg.delta_dtype not in _F32_CODECS:
        raise NotImplementedError(
            f"delta_dtype {cfg.delta_dtype!r}: the codec transport is not "
            f"ported; only float32 (the identity codec) is")


def init_outer_state(params: Flat) -> OuterState:
    some = next(iter(params.values()))
    return OuterState(
        v={k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
           for k, p in params.items()},
        t=torch.zeros((), dtype=torch.int32, device=some.device))


def _average(workers: List[torch.Tensor], anchor: torch.Tensor,
             cfg: DiLoCoConfig) -> torch.Tensor:
    """Mean over workers of the f32 deltas ``w - anchor`` of one leaf,
    summed in worker order (for K = 2 exactly the JAX package's mean)."""
    require_ported(cfg)
    g = anchor.float()
    acc = workers[0].float() - g
    for w in workers[1:]:
        acc = acc + (w.float() - g)
    return acc / len(workers)


def outer_update(global_params: Flat, avg_delta: Flat, state: OuterState,
                 cfg: DiLoCoConfig) -> Tuple[Flat, OuterState]:
    """Nesterov-momentum SGD on the averaged delta (the pseudo-gradient is
    −Δθ̄).  Returns new parameter and momentum tensors."""
    mu, eta = cfg.outer_momentum, cfg.outer_lr
    new_p, new_v = {}, {}
    for k, p in global_params.items():
        d = avg_delta[k].float()
        v = mu * state.v[k] + d
        step_dir = d + mu * v if cfg.nesterov else v
        new_p[k] = (p.float() + eta * step_dir).to(p.dtype)
        new_v[k] = v
    return new_p, OuterState(new_v, state.t + 1)


@torch.no_grad()
def outer_step(global_params: Flat, worker_params: List[Flat],
               state: OuterState, cfg: DiLoCoConfig
               ) -> Tuple[Flat, OuterState]:
    """Average the workers' deltas and apply the outer update."""
    avg = {k: _average([w[k] for w in worker_params], p, cfg)
           for k, p in global_params.items()}
    return outer_update(global_params, avg, state, cfg)
