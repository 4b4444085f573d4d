"""Meshes of the port (the JAX package's ``launch/mesh.py``), and the
process mesh its runtime trains on.

Production meshes, shape only.  ``make_production_mesh`` and
``make_host_mesh`` describe a mesh as an ordered ``{axis: size}`` dict
(``MeshShape.shape``), which the dry run and ``models.sharding.spec_for``
take.  They touch no process group and no device, as the reference's
functions touch no device state.  The production fleet is 256 H100s as
(data=32, model=8); multi-pod is (pod, 32, 8), the ``pod`` axis being the
DiLoCo worker boundary.  The reference's TPU pod is (16, 16); here the
``model`` axis stays inside one 8-card NVLink domain, because a 16-way
tensor-parallel axis would put its per-layer collectives on InfiniBand
between hosts.

The process mesh.  ``init_process_mesh(pod, data, model)`` makes this
process one rank of a (pod, data, model) grid of ``torch.distributed``
ranks, pod-major (rank = (pod_index * data + data_index) * model +
model_index), with one group per pod slice (the ranks of one data and
model index across pods: the outer step's all-gather), one per data
slice (the ranks of one pod and model index: DDP's gradient all-reduce)
and one per model slice (the ranks of one pod and data index: tensor
parallelism's all-reduces, ``models/tensor_parallel.py``).  Every rank
creates every group, in the same order.  With ``model`` > 1 each rank
of a model group holds its shards of the one worker (``cfg``'s layout,
``models.sharding.tp_layout``); ``model`` 1 is the (pod, data) mesh
as it was.  With ``fsdp`` (and ``data`` > 1) each rank of a data group
holds its shards of the pod's worker too, ZeRO-3 style
(``models.sharding.fsdp_layout``: every matrix's ``fsdp`` dim over
``data``): the parameters, the optimizer state and DiLoCo's outer state
are shards, a layer's weights are all-gathered over ``data`` before it
runs and their gradients reduce-scattered (``models/fsdp.py``); without
it the data axis replicates the worker (the reference's "dp" treatment
of the axis; with it, its "2d" / ``dp_fsdp`` rule).  Its
``replicate_fn`` is the transport's replicate hop across pods
(``core/transport.py``: the all-gather of every worker's encoded row; a
quorum round's contributors' rows only, one broadcast each) and carries
the other exchanges a run across ranks makes (``PodReplicate``: gossip's
point-to-point hop, the fleet's loss row, the quorum masks' check, a
checkpoint's gather to rank 0).  ``data_view`` sees the same ranks as
one pod's data axis (DDP over every rank: plain DDP on a multi-pod mesh,
the hybrid pipeline's mid and SFT stages), its model axis kept.
``run_ranks`` starts the ranks with the ``spawn`` start method (CUDA
does not survive ``fork``).

Hardware constants: the H100 SXM data sheet's dense bf16 tensor-core rate,
HBM3 rate and capacity, and NVLink 4's rate per direction (``ICI_BW``
keeps the reference's name for the intra-pod link); ``DCN_BW`` is the
boundary link across pods, one 100 Gbit/s Ethernet port, the link
``launch/comm_sim.py`` models.  Line rates, not measurements.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import shutil
import tempfile
import time
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.launch import collectives
from repro_torch.launch.collectives import (all_gather_rows, all_reduce_mean,
                                            barrier, broadcast_rows,
                                            gather_to_lead, send_recv_rows)

PEAK_FLOPS_BF16 = 989e12      # FLOP/s per card, dense bf16
HBM_BW = 3.35e12              # bytes/s per card
HBM_PER_CHIP = 80e9           # bytes per card
NVLINK_BW = 450e9             # bytes/s per card per direction (NVLink 4)
ICI_BW = NVLINK_BW
DCN_BW = 100e9 / 8            # bytes/s per worker across pods (100 Gbit/s)


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh by its axes alone: ``shape`` maps axis name -> size, in
    order."""
    axes: Tuple[Tuple[str, int], ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(self.axes)

    @property
    def size(self) -> int:
        n = 1
        for _, s in self.axes:
            n *= s
        return n


def make_production_mesh(*, multi_pod: bool = False,
                         num_pods: int = 2) -> MeshShape:
    """Single pod: (data=32, model=8), 256 cards.  Multi-pod: (num_pods,
    32, 8); the default 2 pods are the dry run's target, and larger
    DiLoCo fleets (one worker a pod) reuse the same axes."""
    axes = (("data", 32), ("model", 8))
    return MeshShape((("pod", num_pods),) + axes if multi_pod else axes)


def make_host_mesh(data: int = 1, model: int = 1) -> MeshShape:
    """A small (data, model) mesh, for tests."""
    return MeshShape((("data", data), ("model", model)))


# ---------------------------------------------------------------------------
# The process mesh
# ---------------------------------------------------------------------------

class PodReplicate:
    """The replicate hop over a process mesh, as the transport's
    ``replicate_fn``: ``{path: (1, ...) row}`` -> ``{path: (P, ...)}``, every
    pod's row in pod order (``sources``: those pods' rows only, one
    broadcast each).  It also tells the trainer which worker row this
    process holds (``rows``, of ``num_rows``), how to cut its batch
    (``local_batch``), how to reduce its gradients over the data axis
    (``grad_reduce``, None on one data rank) and how to tag its
    collectives (``scope``), and it carries the other exchanges a run
    across ranks needs: gossip's point-to-point hop (``peer_rows``), the
    fleet's rows of a small tensor (``fleet_rows``: the loss row), a
    check that the ranks agree (``agree``), a checkpoint's gather to the
    writer (``gather_to_lead``, ``lead``) and a ``barrier``."""

    def __init__(self, mesh: "ProcessMesh"):
        self.mesh = mesh

    @property
    def rows(self) -> Tuple[int, ...]:
        return (self.mesh.pod_index,)

    @property
    def num_rows(self) -> int:
        return self.mesh.pod

    @property
    def lead(self) -> bool:
        """This rank writes what the run writes (rank 0)."""
        return self.mesh.rank == 0

    @property
    def grad_reduce(self) -> Optional[Callable]:
        return self.mesh.grad_reduce if self.mesh.data > 1 else None

    @property
    def tp(self) -> Optional["ProcessMesh"]:
        """The mesh when its model axis splits the worker (``model`` > 1),
        else None: what ``models.tensor_parallel.use`` takes."""
        return self.mesh if self.mesh.model > 1 else None

    @property
    def sharded(self) -> Optional["ProcessMesh"]:
        """The mesh when its model axis or ``fsdp`` splits the worker's
        leaves, else None: what ``init`` cuts the parameters by, the
        optimizer and the wire's codec take as their ``axis`` and a
        checkpoint joins over."""
        m = self.mesh
        return m if m.model > 1 or m.fsdp else None

    def local_batch(self, batch):
        return self.mesh.local_batch(batch)

    def scope(self, name: str):
        """Tag the collectives issued inside (``collectives.scope``)."""
        return collectives.scope(name)

    def __call__(self, flat: Dict[str, torch.Tensor],
                 sources: Optional[Sequence[int]] = None
                 ) -> Dict[str, torch.Tensor]:
        if sources is None or len(sources) == self.mesh.pod:
            return {k: all_gather_rows(v, self.mesh) for k, v in flat.items()}
        return {k: broadcast_rows(v, sources, self.mesh)
                for k, v in flat.items()}

    def peer_rows(self, t: torch.Tensor, reads: Sequence[int]
                  ) -> Tuple[Optional[torch.Tensor], int]:
        """Gossip's hop: worker w reads row ``reads[w]``.  ``t`` is this
        rank's (1, ...) row; it goes to every other worker that reads it,
        and the row this rank reads comes from its source, shaped and
        typed as ``t``; None when it reads its own.  Returns (that row,
        the bytes this rank sent)."""
        me = self.mesh.pod_index
        sends = [(w, t) for w, src in enumerate(reads)
                 if src == me and w != me]
        recvs = [(reads[me], t)] if reads[me] != me else []
        got = send_recv_rows(sends, recvs, self.mesh)
        return (got[0] if got else None,
                len(sends) * t.numel() * t.element_size())

    def fleet_rows(self, t: torch.Tensor) -> torch.Tensor:
        """Every pod's (1, ...) row of a small tensor, in pod order."""
        return all_gather_rows(t, self.mesh)

    def agree(self, values: Sequence[int], what: str) -> None:
        """Raise unless every pod holds the same ``values`` (a small int
        vector: a quorum round's masks), so ranks that part never wait on
        each other's different collectives."""
        mine = torch.tensor([list(values)], dtype=torch.int32,
                            device=self.mesh.device)
        every = self.fleet_rows(mine)
        if not bool((every == mine).all()):
            raise RuntimeError(f"the ranks disagree on {what}: "
                               f"{every.cpu().tolist()}")

    def gather_to_lead(self, t: torch.Tensor):
        """Every pod's row of ``t``, on the host, at the pod-0 rank of
        this rank's pod group (None at the others); rank 0's (``lead``)
        is what a checkpoint writes."""
        return gather_to_lead(t, self.mesh)

    def barrier(self) -> None:
        barrier(self.mesh)


@dataclasses.dataclass
class ProcessMesh:
    """This process's place in a (pod, data, model) grid of ranks and its
    groups (``init_process_mesh``); ``layout`` (``model`` > 1) maps each
    parameter leaf to the dim its shards split over the model axis, and
    ``data_layout`` (``fsdp``) to the dim they split over the data axis
    (``models.sharding``)."""
    pod: int
    data: int
    rank: int
    backend: str
    device: torch.device
    pod_group: Any = None           # same data and model index, every pod
    data_group: Any = None          # same pod and model index, every data
    pod_ranks: Tuple[int, ...] = ()  # global rank of each pod-group rank
    spans_pods: bool = False        # the data group holds ranks of >1 pod
    model: int = 1
    model_group: Any = None         # same pod and data index, every model
    layout: Optional[Dict[str, Optional[int]]] = None
    # same model index, every pod and data index (``data_view``'s group)
    flat_data_group: Any = None
    data_layout: Optional[Dict[str, Optional[int]]] = None

    @property
    def fsdp(self) -> bool:
        """Whether the data axis shards the worker (ZeRO-3)."""
        return self.data_layout is not None

    @property
    def pod_index(self) -> int:
        return self.pod_of(self.rank)

    @property
    def data_index(self) -> int:
        return (self.rank // self.model) % self.data

    @property
    def model_index(self) -> int:
        return self.rank % self.model

    def pod_of(self, rank: int) -> int:
        """The pod of global rank ``rank``."""
        return rank // (self.data * self.model)

    def rank_of(self, pod: int, data: int, model: int) -> int:
        """The global rank at (pod, data, model)."""
        return (pod * self.data + data) * self.model + model

    @property
    def replicate_fn(self) -> PodReplicate:
        return PodReplicate(self)

    # the model axis, as the layers (``models.tensor_parallel``), the
    # optimizer (``axis=``) and the wire's codec (``axis=``) take it
    def split_dim(self, path: str) -> Optional[int]:
        """The dim (from the end) ``layout`` splits leaf ``path`` on over
        the model axis (any path ending in a leaf's), or None: whole."""
        from repro_torch.models.sharding import split_of
        return None if self.layout is None else split_of(path, self.layout)

    def model_all_reduce(self, t: torch.Tensor, op: str = "sum"
                         ) -> torch.Tensor:
        """``t``'s SUM or MAX over the model group."""
        return collectives.all_reduce_model(t, self, op)

    def model_all_gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """The model group's tensors joined along ``dim``."""
        return collectives.all_gather_model(t, dim, self)

    def model_gather(self, t: torch.Tensor, dim: int
                     ) -> Optional[torch.Tensor]:
        """``model_all_gather``'s join at model index 0 only (None at the
        other model ranks)."""
        return collectives.gather_model(t, dim, self)

    def model_part(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's contiguous piece of a whole ``t`` along ``dim``."""
        return t.chunk(self.model, dim=dim)[self.model_index]

    # the data axis under ``fsdp``, as the layers (``models.fsdp``), the
    # optimizer and the wire's codec take it
    def data_split_dim(self, path: str) -> Optional[int]:
        """The dim (from the end) ``data_layout`` splits leaf ``path`` on
        over the data axis, or None: whole (or no ``fsdp``)."""
        from repro_torch.models.sharding import split_of
        return split_of(path, self.data_layout)

    def splits(self, path: str) -> bool:
        """Whether a mesh axis splits leaf ``path``."""
        return (self.split_dim(path) is not None
                or self.data_split_dim(path) is not None)

    def data_all_gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """The data group's tensors joined along ``dim``."""
        return collectives.all_gather_data(t, dim, self)

    def data_reduce_scatter(self, t: torch.Tensor, dim: int
                            ) -> torch.Tensor:
        """The mean of ``t`` over the data group, this rank's piece along
        ``dim``."""
        return collectives.reduce_scatter_data(t, dim, self)

    def data_all_reduce(self, t: torch.Tensor, op: str = "sum"
                        ) -> torch.Tensor:
        """``t``'s SUM or MAX over the data group."""
        return collectives.all_reduce_data(t, self, op)

    def data_part(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's contiguous piece of a whole ``t`` along ``dim``."""
        return t.chunk(self.data, dim=dim)[self.data_index]

    def reduce_leaves(self, paths, parts, op: str = "sum"):
        """Each leaf's partial ``parts[i]`` (same-shaped tensors, one a
        path of ``paths``) reduced (SUM or MAX) over every group that
        splits that leaf: one all-reduce over the model group for the
        leaves it splits, then one over the data group for those
        ``fsdp`` splits, each of the stacked partials.  A whole leaf's
        partial is returned as it is, so it counts once."""
        parts = list(parts)
        for split, reduce in ((self.split_dim, self.model_all_reduce),
                              (self.data_split_dim, self.data_all_reduce)):
            idx = [i for i, p in enumerate(paths) if split(p) is not None]
            if idx:
                summed = reduce(torch.stack([parts[i] for i in idx]), op)
                for j, i in enumerate(idx):
                    parts[i] = summed[j]
        return parts

    def own(self, flat: Dict[str, Any]) -> Dict[str, Any]:
        """This rank's shards of one-process flat tensors or arrays (any
        path ending in a leaf's), over the model axis and under ``fsdp``
        the data axis (``models.sharding.shard``), copied."""
        from repro_torch.models.sharding import shard
        return shard(flat, self.layout, self.model_index, self.model,
                     fsdp=self.data_layout, data_index=self.data_index,
                     data=self.data)

    def grad_reduce(self, grads: Dict[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
        """Each gradient's mean over the data ranks of this pod; under
        ``fsdp`` the whole leaves' only, since a split leaf's gradient
        came reduce-scattered out of the backward (``models.fsdp``)."""
        return {k: g if self.data_split_dim(k) is not None
                else all_reduce_mean(g, self) for k, g in grads.items()}

    def local_batch(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        """This rank's part of a worker-stacked batch ``{name: (K, B,
        ...)}``: the row of its pod (K = the pod count), then its data
        index's contiguous ``B / data`` rows; ``(1, B / data, ...)``."""
        out = {}
        for k, v in batch.items():
            if v.shape[0] != self.pod:
                raise ValueError(f"batch {k!r} has {v.shape[0]} worker rows; "
                                 f"the mesh has {self.pod} pods")
            b = v.shape[1]
            if b % self.data:
                raise ValueError(f"batch {k!r}: {b} rows do not split over "
                                 f"{self.data} data ranks")
            n = b // self.data
            p, d = self.pod_index, self.data_index
            out[k] = v[p:p + 1, d * n:(d + 1) * n]
        return out

    def data_view(self) -> "ProcessMesh":
        """The same ranks as one pod's data axis: (pod 1, data P x D,
        model M), DDP over every rank of one model index (the hybrid
        pipeline's mid and SFT stages after its DiLoCo base stage on the
        pods).  Rank order is kept, so data index = rank // M, and the
        model axis and its groups are this mesh's.  Its data group spans
        the pods, so its all-reduces are logged as crossing them."""
        import torch.distributed as dist
        if self.pod * self.data == 1:
            return self
        if self.fsdp:
            raise NotImplementedError(
                "a data view of an fsdp mesh: its data axis would need the "
                "shards of P x D data ranks, not D (hybrid's mid and SFT "
                "stages, plain ddp across pods); ROADMAP §1 queues it")
        return dataclasses.replace(
            self, pod=1, data=self.pod * self.data, pod_group=None,
            pod_ranks=(), spans_pods=self.pod > 1,
            data_group=(dist.group.WORLD if self.model == 1
                        else self.flat_data_group))

    def close(self) -> None:
        import torch.distributed as dist
        if dist.is_initialized():
            dist.destroy_process_group()


def _device_for(device, backend: str, rank: int, world: int) -> torch.device:
    """The rank's device: the CPU, or card ``local_rank % cards``.  NCCL
    refuses two ranks on one card ("Duplicate GPU detected"), so ``nccl``
    with fewer cards than local ranks is refused here, before any rank
    waits on another."""
    device = torch.device(device)
    if device.type == "cpu":
        if backend == "nccl":
            raise ValueError("nccl runs on CUDA devices; on the CPU pass "
                             "backend='gloo'")
        return device
    cards = torch.cuda.device_count()
    if cards == 0:
        raise RuntimeError("device='cuda' but no CUDA card is visible; pass "
                           "device='cpu' to train on the CPU")
    local = int(os.environ.get("LOCAL_RANK", rank))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if backend == "nccl" and cards < local_world:
        raise ValueError(
            f"backend 'nccl' with {local_world} ranks on {cards} card(s): "
            f"NCCL rejects two ranks on one card; pass backend='gloo' (the "
            f"ranks still compute on the card, and each collective is "
            f"staged through the host)")
    dev = torch.device("cuda", local % cards)
    torch.cuda.set_device(dev)
    return dev


def init_process_mesh(pod: int, data: int = 1, model: int = 1, *,
                      backend: str = "nccl", device="cuda",
                      rank: Optional[int] = None,
                      world_size: Optional[int] = None,
                      init_method: Optional[str] = None,
                      timeout_s: float = 600.0, cfg=None,
                      fsdp: bool = False) -> ProcessMesh:
    """Join (or start) the default process group as one rank of a (pod,
    data, model) mesh and build its groups (on a default group already
    joined, another mesh of the same ranks).  ``rank`` / ``world_size``
    default to ``$RANK`` / ``$WORLD_SIZE`` and ``init_method`` to
    ``env://`` (as under ``torchrun``); ``timeout_s`` bounds every wait on
    another rank, so a dead rank fails the others instead of hanging
    them.  ``model`` > 1 needs the model config ``cfg``, whose layout
    (``models.sharding.tp_layout``) the ranks split; a family the port
    does not run tensor-parallel is refused here, by name.  ``fsdp``
    with ``data`` > 1 shards each leaf's ``fsdp`` dim over the data
    ranks too (``models.sharding.fsdp_layout`` of ``cfg``; off, the
    default, the data ranks replicate the worker; on one data rank
    there is nothing to shard)."""
    import torch.distributed as dist
    if pod < 1 or data < 1 or model < 1:
        raise ValueError(f"mesh axes must be >= 1, got pod {pod} data "
                         f"{data} model {model}")
    layout = None
    if model > 1:
        if cfg is None:
            raise ValueError("a mesh with model > 1 needs the model config "
                             "(cfg=): its layout says what each rank holds")
        from repro_torch.models.sharding import tp_layout
        layout = tp_layout(cfg, model)
    data_layout = None
    if fsdp and data > 1:
        if cfg is None:
            raise ValueError("an fsdp mesh needs the model config (cfg=): "
                             "its layout says what each rank holds")
        from repro_torch.models.sharding import fsdp_layout
        data_layout = fsdp_layout(cfg, data, model)
    if not dist.is_initialized():
        rank = int(os.environ["RANK"]) if rank is None else rank
        world = (int(os.environ["WORLD_SIZE"]) if world_size is None
                 else world_size)
    else:
        rank, world = dist.get_rank(), dist.get_world_size()
    if world != pod * data * model:
        raise ValueError(f"{world} ranks cannot form a (pod {pod}, data "
                         f"{data}, model {model}) mesh")
    dev = _device_for(device, backend, rank, world)
    if not dist.is_initialized():
        dist.init_process_group(
            backend, init_method=init_method or "env://", rank=rank,
            world_size=world,
            timeout=datetime.timedelta(seconds=timeout_s))
    mesh = ProcessMesh(pod=pod, data=data, rank=rank,
                       backend=dist.get_backend(), device=dev, model=model,
                       layout=layout, data_layout=data_layout)
    at = mesh.rank_of
    # every rank makes every group, in the same order
    if pod > 1:
        for d in range(data):
            for m in range(model):
                g = dist.new_group([at(p, d, m) for p in range(pod)])
                if (d, m) == (mesh.data_index, mesh.model_index):
                    mesh.pod_group = g
                    mesh.pod_ranks = tuple(dist.get_global_rank(g, i)
                                           for i in range(pod))
    if data > 1:
        for p in range(pod):
            for m in range(model):
                g = dist.new_group([at(p, d, m) for d in range(data)])
                if (p, m) == (mesh.pod_index, mesh.model_index):
                    mesh.data_group = g
    if model > 1:
        for p in range(pod):
            for d in range(data):
                g = dist.new_group([at(p, d, m) for m in range(model)])
                if (p, d) == (mesh.pod_index, mesh.data_index):
                    mesh.model_group = g
        if pod * data > 1:
            for m in range(model):
                g = dist.new_group([at(p, d, m) for p in range(pod)
                                    for d in range(data)])
                if m == mesh.model_index:
                    mesh.flat_data_group = g
    if mesh.backend == "nccl":
        # NCCL makes a group's communicator at its first collective, which
        # every member must enter; point-to-point sends between some of
        # them (gossip) may come first, so make them now
        for g in (mesh.pod_group, mesh.data_group, mesh.model_group,
                  mesh.flat_data_group):
            if g is not None:
                dist.all_reduce(torch.zeros(1, device=dev), group=g)
    return mesh


def _rank_entry(rank: int, fn: Callable, world: int, init_method: str,
                args: tuple) -> None:
    fn(rank, world, init_method, *args)


def run_ranks(fn: Callable, world: int, *args,
              timeout_s: float = 600.0) -> None:
    """Run ``fn(rank, world, init_method, *args)`` in ``world`` processes
    started with ``spawn`` (``fn`` and ``args`` must pickle), with a
    file-store rendezvous ``init_method`` in a fresh temporary directory.
    Raises if a rank fails (the others are then terminated) or if the
    ranks are not done within ``timeout_s``; no rank outlives the call."""
    import torch.multiprocessing as mp
    tmp = tempfile.mkdtemp(prefix="repro_torch_pg_")
    ctx = mp.start_processes(
        _rank_entry, args=(fn, world, f"file://{os.path.join(tmp, 'pg')}",
                           args),
        nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout_s
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{world} ranks not done after "
                                   f"{timeout_s:.0f} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()
        shutil.rmtree(tmp, ignore_errors=True)
