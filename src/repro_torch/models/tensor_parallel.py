"""Tensor parallelism over the ``model`` axis of a process mesh, by hand:
the Megatron-style ``autograd.Function``s that the layers call where the
reference's ``logical_constraint`` lets XLA's partitioner split the
heads, the MLP and the vocab (``src/repro/models/{attention,layers,
transformer}.py``).

Each rank of a model group holds its shards (``models.sharding
.tp_layout``): a contiguous run of the query and KV heads (``wq`` /
``wk`` / ``wv`` by columns, ``wo`` by rows), of the MLP's hidden columns
(``w_up`` / ``w_gate`` by columns, ``w_down`` by rows) and of the vocab
(the embedding table by rows, ``unembed`` by columns).  The residual
stream and the norms are whole on every rank.

* ``copy_to_model(x)``: the identity forward; the all-reduce SUM of the
  gradient backward (x feeds column-parallel products on every rank);
* ``reduce_from_model(x)``: the all-reduce SUM forward (a row-parallel
  product's partial sums); the identity backward;
* ``vocab_embedding(table, tokens)``: ids outside this rank's rows are
  looked up as row 0 and zeroed, then ``reduce_from_model``: every id is
  one rank's row plus zeros, the one-process lookup exactly;
* ``vocab_parallel_ce(logits, labels, z_loss)``: per-position CE of
  vocab-split logits: the global max by an all-reduce MAX, the sum of
  exps and the gold logit by one all-reduce SUM; the backward is local
  (softmax minus one-hot, scaled), since the logits' own backward
  through ``copy_to_model`` sums the ranks' parts of dh.

Serving (no backward):

* ``seq_parallel_attention(m, l, acc)``: the ``kv_seq`` decode's merge.
  Each rank's partial softmax states of its ring slots' chunks (the ring
  kernel's split half) are all-gathered in model-index order, which is
  ascending slot order, and merged once (its combine half): every rank
  gets the whole attention output;
* ``vocab_parallel_argmax(logits)``: the greedy id of vocab-split logits,
  the same on every model rank, ties to the lower id as ``torch.argmax``.

The active mesh.  ``use(mesh)`` makes ``mesh`` (a ``launch.mesh
.ProcessMesh`` with ``model`` > 1) the one the layers reduce over; the
trainers enter it around their inner steps and rounds.  It is a
process-wide stack, not a thread-local: the autograd engine runs a CUDA
backward, and remat's recompute in it, on a thread of its own.  The
collectives are the mesh's own (``model_all_reduce`` /
``model_all_gather``), so this module imports none; the optimizer and
the wire's codec take the mesh as an argument (``axis=``) instead of
reading the stack.  With no mesh active
(or one of ``model`` 1) the layers see whole leaves and call none of
the functions above; a layer handed one rank's shards with no mesh
active raises rather than compute a part as the whole.
"""
from __future__ import annotations

import contextlib
from typing import List

import torch

from repro_torch.kernels.decode_attention import combine_partials

_ACTIVE: List = [None]


@contextlib.contextmanager
def use(mesh):
    """Make ``mesh`` the active model axis inside (None, or a mesh of
    ``model`` 1: none)."""
    _ACTIVE.append(mesh if mesh is not None and mesh.model > 1 else None)
    try:
        yield
    finally:
        _ACTIVE.pop()


def active():
    """The active mesh (``model`` > 1), or None."""
    return _ACTIVE[-1]


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.model_all_reduce(g, "sum"), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return mesh.model_all_reduce(x, "sum")

    @staticmethod
    def backward(ctx, g):
        return g, None


def _mesh():
    """The active mesh, for a layer that holds one rank's shards."""
    mesh = active()
    if mesh is None:
        raise ValueError("these leaves are one rank's shards (a shape off "
                         "the config's) but no model axis is active: run "
                         "under tensor_parallel.use(mesh)")
    return mesh


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    return _CopyToModel.apply(x, _mesh())


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    return _ReduceFromModel.apply(x, _mesh())


def vocab_embedding(table: torch.Tensor, tokens: torch.Tensor
                    ) -> torch.Tensor:
    """Embedding rows of ``tokens`` from this rank's rows of the table
    (``model_index * rows`` onward), summed over the model group."""
    mesh = _mesh()
    n = table.shape[0]
    local = tokens.long() - mesh.model_index * n
    inside = (local >= 0) & (local < n)
    rows = torch.nn.functional.embedding(
        torch.where(inside, local, torch.zeros_like(local)), table)
    rows = torch.where(inside[..., None], rows, torch.zeros_like(rows))
    return reduce_from_model(rows)


class _VocabParallelCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels, z_loss, mesh):
        n = logits.shape[-1]
        m = mesh.model_all_reduce(logits.amax(dim=-1), "max")
        e = torch.exp(logits - m[..., None])
        local = labels.long().clamp(min=0) - mesh.model_index * n
        inside = (local >= 0) & (local < n)
        at = torch.where(inside, local, torch.zeros_like(local))
        gold = torch.gather(logits, -1, at[..., None])[..., 0]
        gold = torch.where(inside, gold, torch.zeros_like(gold))
        s, gold = mesh.model_all_reduce(torch.stack([e.sum(dim=-1), gold]),
                                        "sum").unbind(0)
        lse = m + torch.log(s)
        ce = lse - gold
        if z_loss:
            ce = ce + z_loss * lse.square()
        ctx.z_loss = z_loss
        ctx.save_for_backward(e / s[..., None], lse, at, inside)
        return ce

    @staticmethod
    def backward(ctx, g):
        p, lse, at, inside = ctx.saved_tensors
        coef = g * (1.0 + 2.0 * ctx.z_loss * lse) if ctx.z_loss else g
        d = p * coef[..., None]
        hit = torch.where(inside, g, torch.zeros_like(g))
        d = d.scatter_add(-1, at[..., None], -hit[..., None])
        return d, None, None, None


def vocab_parallel_ce(logits: torch.Tensor, labels: torch.Tensor,
                      z_loss: float = 0.0) -> torch.Tensor:
    """Per-position CE (+ ``z_loss`` lse²) of this rank's vocab columns
    ``logits`` (..., V / M) f32 against global ``labels`` (a label < 0
    reads id 0, as ``softmax_ce_sums`` does; the caller masks it), the
    same on every model rank."""
    return _VocabParallelCE.apply(logits, labels, z_loss, _mesh())


def whole(path: str, t: torch.Tensor, mesh) -> torch.Tensor:
    """The one-process leaf of this rank's shard ``t`` at ``path`` (any
    path ending in a leaf's): all-gathered over ``mesh``'s model group
    along its split dim, then, under ``fsdp``, over its data group along
    its ``fsdp`` dim; ``t`` itself for a whole leaf or another tensor.
    Every rank of those groups must call it on the same paths in the
    same order."""
    dim = mesh.split_dim(path)
    if dim is not None:
        t = mesh.model_all_gather(t, dim)
    dim = mesh.data_split_dim(path)
    return t if dim is None else mesh.data_all_gather(t, dim)


def gather_params(flat, mesh):
    """One-process flat parameters from this rank's shards (``whole``
    leaf by leaf, in path order); ``flat`` itself on a mesh that splits
    no leaf (or none)."""
    if mesh is None or (mesh.model == 1 and not mesh.fsdp):
        return flat
    return {k: whole(k, flat[k], mesh) for k in sorted(flat)}


def seq_parallel_attention(m: torch.Tensor, l: torch.Tensor,
                           acc: torch.Tensor,
                           dtype=torch.float32) -> torch.Tensor:
    """The attention output (..., D) in ``dtype`` from this rank's
    partials, m and l (..., nc) and acc (..., nc, D) f32 over its slots'
    chunks: the model group's partials joined along the chunk dim in
    model-index order (one all-gather of the three packed together), then
    the combine.  The same on every model rank."""
    mesh = _mesh()
    D = acc.shape[-1]
    packed = torch.cat([acc, m[..., None], l[..., None]], dim=-1)
    every = mesh.model_all_gather(packed, -2)
    return combine_partials(every[..., D].contiguous(),
                            every[..., D + 1].contiguous(),
                            every[..., :D].contiguous(), dtype)


def vocab_parallel_argmax(logits: torch.Tensor) -> torch.Tensor:
    """The greedy ids (...,) int64 of this rank's vocab columns ``logits``
    (..., V / M) of every rank's: ``torch.argmax`` of the gathered logits,
    ties to the lower id, the same on every model rank.  Each rank's best
    value and its global id go through one all-gather (ids as f32, exact
    below 2**24)."""
    mesh = _mesh()
    n = logits.shape[-1]
    if n * mesh.model > 1 << 24:
        raise ValueError(f"a vocab of {n * mesh.model} ids does not pass "
                         f"exactly as float32")
    at = logits.argmax(dim=-1, keepdim=True)
    best = torch.gather(logits, -1, at).float()
    ids = (at + mesh.model_index * n).float()
    every = mesh.model_all_gather(torch.cat([best, ids], -1)[..., None, :],
                                  -2)
    rank = every[..., 0].argmax(dim=-1, keepdim=True)
    return torch.gather(every[..., 1], -1, rank)[..., 0].long()
