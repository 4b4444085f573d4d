"""ZeRO-3 over the ``data`` axis of a process mesh, by hand: what the
reference's ``"fsdp": ("data",)`` rule lets XLA's partitioner do for its
"2d" and ``dp_fsdp`` training programs (``src/repro/models/
sharding.py``).

Each rank of a data group holds its ``fsdp`` shards of the worker's
leaves (``models.sharding.fsdp_layout``: every matrix's d_model dim
split over ``data``; the 1-D leaves whole), and so do its optimizer
state and DiLoCo's anchor, outer momentum and residual.  A leaf is
joined only where it is used:

* ``gathered(tree, prefix)``: ``tree``'s leaves (paths ``prefix/...``)
  with every data-split leaf all-gathered over the data group through
  ``_GatherData``, whose forward is ``all_gather_data`` and whose
  backward is ``reduce_scatter_data`` of the gradient: the mean over the
  data ranks, this rank's piece.  So a sharded leaf's gradient leaves
  the backward already averaged, and ``ProcessMesh.grad_reduce``
  all-reduces only the whole leaves.

The model (``models/transformer.py``) gathers each layer's weights at
the top of the layer, which runs under per-layer remat whenever the
mesh shards (``torch.utils.checkpoint``; remat on and off give the same
bits, so this costs a recompute and changes no number): the gathered
weights are not saved, the backward's recompute gathers them again, and
no more than one layer's weights are whole at a time.  The embedding
subtree is gathered once a forward, for the lookup and the logits.

The active mesh.  ``use(mesh)`` makes ``mesh`` (a ``launch.mesh
.ProcessMesh`` with ``fsdp``) the one the layers gather over; the
trainers enter it around their inner steps and rounds, beside
``tensor_parallel.use``.  A process-wide stack, as that one is.  With
no mesh active the layers see the leaves they are given.
"""
from __future__ import annotations

import contextlib
from typing import List

import torch

_ACTIVE: List = [None]


@contextlib.contextmanager
def use(mesh):
    """Make ``mesh`` the active data axis inside (None, or a mesh without
    ``fsdp``: none)."""
    _ACTIVE.append(mesh if mesh is not None and mesh.fsdp else None)
    try:
        yield
    finally:
        _ACTIVE.pop()


def active():
    """The active mesh (``fsdp``), or None."""
    return _ACTIVE[-1]


class _GatherData(torch.autograd.Function):
    @staticmethod
    def forward(ctx, shard, dim, mesh):
        ctx.dim, ctx.mesh = dim, mesh
        return mesh.data_all_gather(shard, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.data_reduce_scatter(g, ctx.dim), None, None


def gathered(tree, prefix: str):
    """``tree`` (a dict of leaves and subtrees at path ``prefix``) with each
    leaf that the active mesh splits over ``data`` all-gathered
    (``_GatherData``); ``tree`` itself with no mesh active.  Every data
    rank must call it on the same leaves in the same order."""
    mesh = active()
    if mesh is None:
        return tree

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, f"{path}/{k}") for k, v in node.items()}
        dim = mesh.data_split_dim(path)
        return node if dim is None else _GatherData.apply(node, dim, mesh)

    return walk(tree, prefix)
