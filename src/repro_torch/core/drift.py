"""Representation-drift diagnostics (paper §4.3: "representation drift",
"alignment fragility"; the JAX package's ``core/drift.py``).

The paper *hypothesizes* that prolonged local optimization makes workers'
embedding spaces diverge so their averaged deltas are "globally coherent but
locally inconsistent".  These diagnostics make that measurable:

* ``param_drift``      — per-worker L2 / cosine dispersion of parameter deltas
* ``linear_cka``       — centered kernel alignment between two activation
                         matrices (standard representation-similarity metric)
* ``worker_cka_matrix``— pairwise CKA of per-worker hidden states on a probe
                         batch (K×K) — low off-diagonal = drifted workers
* ``subspace_overlap`` — principal-angle overlap of the top-r activation
                         subspaces (captures "feature geometry" changes the
                         Hybrid run cannot undo)

The port's ``DiLoCoState.worker_params`` is a list of K flat dicts, not a
stacked (K, ...) tree, so ``param_drift`` and ``worker_cka_matrix`` take
that list.  ``param_drift`` never builds the (K, P) stack of the deltas
(8.4 GB at K 4 and 525 M parameters): every output is a function of the
K × K Gram matrix of the deltas, which it accumulates leaf by leaf, in
slices of at most ``GRAM_SLICE`` elements, in float64.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

import torch

# elements of one leaf whose K deltas are stacked at a time
GRAM_SLICE = 1 << 24


def _tensors(tree) -> List[torch.Tensor]:
    """The leaves of a (nested) dict / list of tensors, dict keys sorted."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _tensors(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    return [tree]


def delta_cosine(tree_a, tree_b) -> torch.Tensor:
    """Cosine similarity between two delta trees (flattened).  The
    async-gossip apply rule uses this as its observed-drift signal: a
    stale peer delta pointing away from the local one gets down-weighted
    toward zero instead of averaged in at full weight.  Sums run per leaf
    in float32 and across leaves in float64."""
    dot = sq_a = sq_b = 0.0
    for a, b in zip(_tensors(tree_a), _tensors(tree_b)):
        a, b = a.float().reshape(-1), b.float().reshape(-1)
        dot = dot + torch.dot(a, b).double()
        sq_a = sq_a + torch.dot(a, a).double()
        sq_b = sq_b + torch.dot(b, b).double()
    return dot / (torch.sqrt(sq_a) * torch.sqrt(sq_b) + 1e-12)


def delta_gram(worker_params: List[Dict[str, torch.Tensor]],
               global_params: Dict[str, torch.Tensor]) -> torch.Tensor:
    """(K, K) float64 Gram matrix of the workers' flattened deltas
    ``w_i - g``, on the parameters' device.  Each delta is taken in the
    parameters' dtype, as the reference's is; widening it to float64 is
    exact for float32 and bfloat16 deltas."""
    k = len(worker_params)
    gram = None
    for path in sorted(global_params):
        g = global_params[path].reshape(-1)
        ws = [w[path].reshape(-1) for w in worker_params]
        for lo in range(0, g.numel(), GRAM_SLICE):
            hi = min(lo + GRAM_SLICE, g.numel())
            d = torch.stack([(w[lo:hi] - g[lo:hi]).double() for w in ws])
            part = d @ d.T
            gram = part if gram is None else gram + part
    if gram is None:
        gram = torch.zeros((k, k), dtype=torch.float64)
    return gram


def rejoin_drift(worker_params: List[Dict[str, torch.Tensor]],
                 global_params: Dict[str, torch.Tensor],
                 live: Sequence[bool], w: int) -> Tuple[float, float]:
    """A rejoiner's drift, taken on the state BEFORE it adopts the anchor
    (the divergence the rejoin erases): the L2 norm of worker ``w``'s
    delta ``w - g`` and the cosine of that delta to the mean delta of the
    ``live`` workers (``w`` among them), as the reference's rejoin probe
    records them.  All three sums (‖Δ_w‖², Δ_w·Δ̄, ‖Δ̄‖²) come from the
    live rows' Gram matrix (``delta_gram``), accumulated leaf by leaf in
    float64, so no (K, P) stack is built.  Returns host floats."""
    rows = [i for i, keep in enumerate(live) if keep]
    gram = delta_gram([worker_params[i] for i in rows], global_params)
    j, n = rows.index(w), len(rows)
    sq_w = gram[j, j]
    dot_mean = gram[j].sum() / n            # Δ_w · Δ̄
    sq_mean = gram.sum() / (n * n)          # ‖Δ̄‖²
    norm = torch.sqrt(sq_w)
    cos = dot_mean / (norm * torch.sqrt(sq_mean) + 1e-12)
    return float(norm), float(cos)


def param_drift(worker_params: List[Dict[str, torch.Tensor]],
                global_params: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
    """Dispersion of per-worker deltas: the mean and the (ddof 0) standard
    deviation of their norms, the mean cosine of each delta to the mean
    delta, and the mean pairwise cosine (1 for one worker).  0-d float64
    tensors on the parameters' device, from ``delta_gram``."""
    k = len(worker_params)
    gram = delta_gram(worker_params, global_params)
    norms = torch.sqrt(torch.diagonal(gram))
    # mean delta m = (1/K) sum_j d_j:  d_i . m = row sum / K,
    # |m|^2 = total / K^2
    dot_mean = gram.sum(dim=1) / k
    mean_norm = torch.sqrt(gram.sum()) / k + 1e-12
    cos = dot_mean / (norms * mean_norm + 1e-12)
    unit = norms + 1e-12
    pair = gram / (unit[:, None] * unit[None, :])
    off = ((pair.sum() - k) / (k * (k - 1)) if k > 1
           else torch.ones((), dtype=gram.dtype, device=gram.device))
    return {"delta_norm_mean": norms.mean(),
            "delta_norm_std": torch.std(norms, correction=0),
            "cos_to_mean": cos.mean(),
            "pairwise_cos": off}


def linear_cka(X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """Linear CKA between (n, d1) and (n, d2) activation matrices."""
    X = X - X.mean(dim=0)
    Y = Y - Y.mean(dim=0)
    xty = torch.linalg.norm(X.T @ Y) ** 2
    xtx = torch.linalg.norm(X.T @ X)
    yty = torch.linalg.norm(Y.T @ Y)
    return xty / (xtx * yty + 1e-12)


def worker_cka_matrix(worker_params: List, probe_fn: Callable,
                      probe_batch) -> torch.Tensor:
    """probe_fn(params, batch) -> (..., d) hidden states, for each of the K
    entries of ``worker_params``.  Returns the (K, K) CKA matrix."""
    acts = [probe_fn(p, probe_batch) for p in worker_params]
    acts = [a.reshape(-1, a.shape[-1]) for a in acts]
    k = len(acts)
    return torch.stack([torch.stack([linear_cka(acts[i], acts[j])
                                     for j in range(k)]) for i in range(k)])


def subspace_overlap(X: torch.Tensor, Y: torch.Tensor,
                     r: int = 8) -> torch.Tensor:
    """Overlap of top-r right singular subspaces of two (n, d) matrices:
    (1/r)·||U_x^T U_y||_F^2 ∈ [0, 1].  The singular vectors' signs do not
    matter to it; a tie at the r-th singular value does."""
    X = X - X.mean(dim=0)
    Y = Y - Y.mean(dim=0)
    _, _, vx = torch.linalg.svd(X, full_matrices=False)
    _, _, vy = torch.linalg.svd(Y, full_matrices=False)
    ux, uy = vx[:r], vy[:r]
    return torch.linalg.norm(ux @ uy.T) ** 2 / r
