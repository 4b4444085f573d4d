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

The process mesh.  ``init_process_mesh(pod, data)`` makes this process
one rank of a (pod, data) grid of ``torch.distributed`` ranks, pod-major
(rank = pod_index * data + data_index), with one group per pod slice
(the ranks of one data index across pods: the outer step's all-gather)
and one per data slice (the ranks of one pod: DDP's gradient all-reduce).
Every rank creates every group, in the same order.  Its
``replicate_fn`` is the transport's replicate hop across pods
(``core/transport.py``: the all-gather of every worker's encoded row; a
quorum round's contributors' rows only, one broadcast each) and carries
the other exchanges a run across ranks makes (``PodReplicate``: gossip's
point-to-point hop, the fleet's loss row, the quorum masks' check, a
checkpoint's gather to rank 0).  ``data_view`` sees the same ranks as
one pod's data axis (DDP over every rank: plain DDP on a multi-pod mesh,
the hybrid pipeline's mid and SFT stages).  ``run_ranks`` starts the
ranks with the ``spawn`` start method (CUDA does not survive
``fork``).

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
    """This process's place in a (pod, data) grid of ranks and its two
    groups (``init_process_mesh``)."""
    pod: int
    data: int
    rank: int
    backend: str
    device: torch.device
    pod_group: Any = None           # same data index, every pod
    data_group: Any = None          # same pod, every data index
    pod_ranks: Tuple[int, ...] = ()  # global rank of each pod-group rank
    spans_pods: bool = False        # the data group holds ranks of >1 pod

    @property
    def pod_index(self) -> int:
        return self.rank // self.data

    @property
    def data_index(self) -> int:
        return self.rank % self.data

    @property
    def replicate_fn(self) -> PodReplicate:
        return PodReplicate(self)

    def grad_reduce(self, grads: Dict[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
        """Each gradient's mean over the data ranks of this pod."""
        return {k: all_reduce_mean(g, self) for k, g in grads.items()}

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
        """The same ranks as one pod's data axis: (pod 1, data P x D),
        DDP over every rank of the world (the hybrid pipeline's mid and
        SFT stages after its DiLoCo base stage on the pods).  Rank order
        is kept, so data index = rank.  Its data group spans the pods, so
        its all-reduces are logged as crossing them."""
        import torch.distributed as dist
        if self.pod * self.data == 1:
            return self
        return dataclasses.replace(self, pod=1, data=self.pod * self.data,
                                   pod_group=None, pod_ranks=(),
                                   data_group=dist.group.WORLD,
                                   spans_pods=self.pod > 1)

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


def init_process_mesh(pod: int, data: int = 1, *, backend: str = "nccl",
                      device="cuda", rank: Optional[int] = None,
                      world_size: Optional[int] = None,
                      init_method: Optional[str] = None,
                      timeout_s: float = 600.0) -> ProcessMesh:
    """Join (or start) the default process group as one rank of a (pod,
    data) mesh and build its groups.  ``rank`` / ``world_size`` default to
    ``$RANK`` / ``$WORLD_SIZE`` and ``init_method`` to ``env://`` (as under
    ``torchrun``); ``timeout_s`` bounds every wait on another rank, so a
    dead rank fails the others instead of hanging them."""
    import torch.distributed as dist
    if pod < 1 or data < 1:
        raise ValueError(f"mesh axes must be >= 1, got pod {pod} data {data}")
    if not dist.is_initialized():
        rank = int(os.environ["RANK"]) if rank is None else rank
        world = (int(os.environ["WORLD_SIZE"]) if world_size is None
                 else world_size)
    else:
        rank, world = dist.get_rank(), dist.get_world_size()
    if world != pod * data:
        raise ValueError(f"{world} ranks cannot form a (pod {pod}, data "
                         f"{data}) mesh")
    dev = _device_for(device, backend, rank, world)
    if not dist.is_initialized():
        dist.init_process_group(
            backend, init_method=init_method or "env://", rank=rank,
            world_size=world,
            timeout=datetime.timedelta(seconds=timeout_s))
    mesh = ProcessMesh(pod=pod, data=data, rank=rank,
                       backend=dist.get_backend(), device=dev)
    # every rank makes every group, in the same order
    if pod > 1:
        for d in range(data):
            g = dist.new_group([p * data + d for p in range(pod)])
            if d == mesh.data_index:
                mesh.pod_group = g
                mesh.pod_ranks = tuple(dist.get_global_rank(g, i)
                                       for i in range(pod))
    if data > 1:
        for p in range(pod):
            g = dist.new_group([p * data + d for d in range(data)])
            if p == mesh.pod_index:
                mesh.data_group = g
    if mesh.backend == "nccl":
        # NCCL makes a group's communicator at its first collective, which
        # every member must enter; point-to-point sends between some of
        # them (gossip) may come first, so make them now
        for g in (mesh.pod_group, mesh.data_group):
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
