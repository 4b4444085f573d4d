"""The port's collectives, each one logged: the counterpart of the JAX
package's ``launch/hlo_analysis.py weighted_collective_stats`` and
``launch/dryrun_lib.py hlo_collective_stats``.  Those parse the
collectives out of XLA's compiled program; eager PyTorch has no program
to parse, so the port counts the collectives it issues instead.

Every collective of the port goes through the wrappers here:

* ``all_gather_rows(t, mesh)`` — over the mesh's pod group: this rank's
  (1, ...) row in, the (P, ...) rows of every pod out, stacked in POD
  order (the replicate hop of the outer step);
* ``broadcast_rows(t, sources, mesh)`` — the rows of the pods
  ``sources`` only, in that order, on every rank: one broadcast from
  each source (a quorum round's contributors; a pod outside ``sources``
  sends nothing);
* ``send_recv_rows(sends, recvs, mesh)`` — point-to-point sends and
  receives between pods, posted together (gossip's peer hop);
* ``gather_to_lead(t, mesh)`` — every pod's row on the pod group's first
  rank only (a run checkpoint), through the host;
* ``all_reduce_mean(t, mesh)`` — over the mesh's data group (or the
  world, for a data view of the whole mesh, whose all-reduces cross
  pods): the mean of the data ranks' tensors (DDP's gradient
  all-reduce);
* ``all_reduce_model(t, mesh, op)`` — the SUM or MAX of ``t`` over the
  mesh's model group (the ranks of one pod and data index: tensor
  parallelism's all-reduces, ``models/tensor_parallel.py``);
* ``all_gather_model(t, dim, mesh)`` — the model ranks' tensors joined
  along ``dim``, in model-index order (Muon's whole matrix, a gather of
  shards into the one-process layout);
* ``gather_model(t, dim, mesh)`` — the same join at model index 0 only
  (a run checkpoint's shards, which one rank writes);
* ``reduce_scatter_data(t, dim, mesh)`` — over the data group: the mean
  of the data ranks' ``t``, this rank's contiguous piece along ``dim``
  (the gradient of a weight gathered by ``fsdp``, ``models/fsdp.py``);
* ``all_gather_data(t, dim, mesh)`` — the data ranks' pieces joined
  along ``dim`` in data-index order (a layer's weights before use under
  ``fsdp``, Muon's whole matrix, a checkpoint's join);
* ``all_reduce_data(t, mesh, op)`` — the SUM or MAX of ``t`` over the
  data group (the partial sums of leaves ``fsdp`` splits: the global
  norm, the wire's amax, the drift-aware cosines);
* ``barrier(mesh)`` — every rank of the world.

The data-axis wrappers cross pods only where the data group spans them
(a ``data_view``).  Their gloo calls are gloo's own ``reduce_scatter``,
``all_gather`` and ``all_reduce``, present in both PyTorch builds the
port runs on (2.13 on the CPU, 2.11 with CUDA 12.8 on the card); a CUDA
tensor is staged through pinned host memory as for every gloo call.

Each call appends a ``CollectiveRecord``: the op kind (the reference's
names, ``all-gather`` / ``all-reduce`` / ``reduce-scatter``, and
``broadcast``, ``send``,
``recv``, ``gather``), the mesh axis, the bytes THIS rank sends (its
operand: the one-process transport's ``shipped`` counts each worker's
payload once, and so does this; a ``recv`` record holds the bytes this
rank received, and a broadcast's receivers log a ``recv``), whether the
group crosses a pod boundary, and the seconds spent.  Under ``gloo`` a
CUDA tensor is staged to the host around the call (gloo has no CUDA
all-gather), through pinned memory (copies several times faster than to pageable
memory); the staging is explicit and timed apart (``host_s``), and the
collective itself is ``coll_s``.  CUDA work is synchronized before a
call, so neither time includes compute enqueued before it.  A large
tensor goes to an all-gather, all-reduce or reduce-scatter as up to
``MAX_PIECES`` pieces of about ``PIECE_BYTES``, issued together (gloo
serves the pieces on its threads at once; one 1 GiB piece runs slower);
the record is the call's.

``collective_stats()`` sums the log into the reference's keys
(``bytes_by_kind``, ``count_by_kind``, ``wire_bytes_per_device``, where an
all-reduce counts twice, as a ring all-reduce moves about twice its
payload, and ``cross_pod_bytes_per_device``; the bytes of ``recv``
records are in ``bytes_by_kind`` only, since the sender counts them);
``scope(name)`` tags the records made inside it and ``reset_log()``
clears the log.  The scopes the port uses: ``inner`` (the inner steps),
``outer`` (the outer rounds: the wire), ``loss`` (the fleet's loss row
for an H schedule or a checkpoint's history), ``quorum`` (a quorum
round's masks, checked across ranks), ``consensus`` (K-row reads of
gossip's anchors: ``global_params``, a rejoiner's consensus, the rejoin
drift) and ``checkpoint`` (the gather to the writer).
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch

PIECE_BYTES = 32 * 2 ** 20
MAX_PIECES = 32


@dataclasses.dataclass(frozen=True)
class CollectiveRecord:
    kind: str            # all-gather | all-reduce | reduce-scatter |
    #                      broadcast | send | recv | gather
    axis: str            # the mesh axis: "pod" | "data" | "model"
    nbytes: int          # bytes this rank sends (its operand)
    cross_pod: bool      # the group spans more than one pod
    host_s: float        # staging a CUDA tensor through the host (gloo)
    coll_s: float        # the collective call itself
    scope: Optional[str] = None


_LOG: List[CollectiveRecord] = []
_SCOPE: List[Optional[str]] = [None]


def reset_log() -> None:
    _LOG.clear()


def records(scope: Optional[str] = None) -> List[CollectiveRecord]:
    """The records since ``reset_log()``; those of one scope if named."""
    return [r for r in _LOG if scope is None or r.scope == scope]


@contextlib.contextmanager
def scope(name: str):
    """Tag the records made inside with ``name``."""
    _SCOPE.append(name)
    try:
        yield
    finally:
        _SCOPE.pop()


def collective_stats(scope: Optional[str] = None,
                     axis: Optional[str] = None) -> Dict:
    """The log summed into the reference's collective-statistics keys (per
    device = per rank), plus the seconds staged and spent; those of one
    mesh axis if named."""
    by_kind: Dict[str, int] = {}
    count: Dict[str, int] = {}
    wire = cross = 0
    host_s = coll_s = 0.0
    for r in records(scope):
        if axis is not None and r.axis != axis:
            continue
        by_kind[r.kind] = by_kind.get(r.kind, 0) + r.nbytes
        count[r.kind] = count.get(r.kind, 0) + 1
        b = r.nbytes * {"all-reduce": 2, "recv": 0}.get(r.kind, 1)
        wire += b
        cross += b if r.cross_pod else 0
        host_s += r.host_s
        coll_s += r.coll_s
    return {"bytes_by_kind": by_kind, "count_by_kind": count,
            "wire_bytes_per_device": wire,
            "cross_pod_bytes_per_device": cross,
            "host_s": host_s, "coll_s": coll_s}


def _staged(mesh, t: torch.Tensor) -> bool:
    return t.device.type == "cuda" and mesh.backend == "gloo"


def _sync(t: torch.Tensor) -> None:
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


def _host_copy(t: torch.Tensor) -> torch.Tensor:
    """``t`` in pinned host memory (gloo's operand for a CUDA tensor)."""
    return torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t)


def _log(kind, axis, nbytes, cross, host_s, coll_s) -> None:
    _LOG.append(CollectiveRecord(kind=kind, axis=axis, nbytes=nbytes,
                                 cross_pod=cross, host_s=host_s,
                                 coll_s=coll_s, scope=_SCOPE[-1]))


def _pod_rank(mesh, pod: int) -> int:
    """The global rank of ``pod``'s rank at this rank's data and model
    index."""
    return mesh.rank_of(pod, mesh.data_index, mesh.model_index)


def _pieces(x: torch.Tensor):
    """``x`` flat, and the bounds of its pieces."""
    n = x.numel()
    k = max(1, min(MAX_PIECES, n * x.element_size() // PIECE_BYTES))
    return x.reshape(-1), [(n * i // k, n * (i + 1) // k) for i in range(k)]


def _run(mesh, t: torch.Tensor, kind: str, axis: str, cross: bool, call):
    """Stage ``t`` (if gloo holds a CUDA tensor) in pinned memory, run
    ``call`` on the tensor the group takes (it returns the result's parts
    in order), bring them back, and log the call."""
    _sync(t)
    t0 = time.perf_counter()
    staged = _staged(mesh, t)
    x = _host_copy(t) if staged else t
    t1 = time.perf_counter()
    parts = call(x)
    _sync(parts[0])
    t2 = time.perf_counter()
    if staged:
        parts = [p.to(t.device) for p in parts]
    out = parts[0] if len(parts) == 1 else torch.cat(parts)
    _sync(out)
    t3 = time.perf_counter()
    _log(kind, axis, t.numel() * t.element_size(), cross,
         (t1 - t0) + (t3 - t2), t2 - t1)
    return out


def all_gather_rows(t: torch.Tensor, mesh) -> torch.Tensor:
    """Every pod's row of ``t`` (this rank's (1, ...) row) over the mesh's
    pod group: (P, ...) in pod order.  The identity on one pod."""
    import torch.distributed as dist
    if mesh.pod == 1:
        return t

    def call(x):
        parts = [torch.empty(x.shape, dtype=x.dtype, device=x.device,
                             pin_memory=x.is_pinned())
                 for _ in range(mesh.pod)]
        flat, bounds = _pieces(x.contiguous())
        outs = [p.reshape(-1) for p in parts]
        for w in [dist.all_gather([o[a:b] for o in outs], flat[a:b],
                                  group=mesh.pod_group, async_op=True)
                  for a, b in bounds]:
            w.wait()
        # group rank i holds global rank pod_ranks[i]: order by its pod
        order = sorted(range(mesh.pod),
                       key=lambda i: mesh.pod_of(mesh.pod_ranks[i]))
        return [parts[i] for i in order]

    return _run(mesh, t, "all-gather", "pod", True, call)


def broadcast_rows(t: torch.Tensor, sources: Sequence[int], mesh
                   ) -> torch.Tensor:
    """The rows of the pods ``sources`` (ascending), stacked in that
    order, on every rank of the pod group: one broadcast from each source
    of its (1, ...) row.  ``t`` is this rank's row; a rank outside
    ``sources`` sends nothing (its ``t`` gives only the shape and dtype),
    and every rank takes part in every broadcast."""
    import torch.distributed as dist
    me = mesh.pod_index
    _sync(t)
    staged = _staged(mesh, t)
    rows = []
    for src in sources:
        t0 = time.perf_counter()
        if src == me:
            buf = _host_copy(t) if staged else t.contiguous().clone()
        else:
            buf = torch.empty(t.shape, dtype=t.dtype,
                              device="cpu" if staged else t.device,
                              pin_memory=staged)
        t1 = time.perf_counter()
        dist.broadcast(buf, src=_pod_rank(mesh, src), group=mesh.pod_group)
        _sync(buf)
        t2 = time.perf_counter()
        row = buf.to(t.device) if staged else buf
        _sync(row)
        t3 = time.perf_counter()
        _log("broadcast" if src == me else "recv", "pod",
             buf.numel() * buf.element_size(), True,
             (t1 - t0) + (t3 - t2), t2 - t1)
        rows.append(row)
    return torch.cat(rows) if rows else t[:0]


def send_recv_rows(sends: Sequence[Tuple[int, torch.Tensor]],
                   recvs: Sequence[Tuple[int, torch.Tensor]], mesh
                   ) -> List[torch.Tensor]:
    """Point-to-point over the pod group: send each ``(pod, tensor)`` of
    ``sends`` to that pod, and receive one tensor shaped and typed as
    ``like`` from each ``(pod, like)`` of ``recvs``, all posted together
    (``batch_isend_irecv``: NCCL groups them; gloo's are asynchronous), so
    no order of posting can deadlock.  Returns the received tensors, in
    ``recvs``' order, on ``like``'s device.  Each send logs a ``send``
    record of its bytes, each receive a ``recv`` record."""
    import torch.distributed as dist
    if not sends and not recvs:
        return []
    some = (sends or recvs)[0][1]
    _sync(some)
    t0 = time.perf_counter()
    staged = _staged(mesh, some)
    out_s = [(p, _host_copy(x) if staged else x.contiguous())
             for p, x in sends]
    in_b = [(p, torch.empty(like.shape, dtype=like.dtype,
                            device="cpu" if staged else like.device,
                            pin_memory=staged)) for p, like in recvs]
    t1 = time.perf_counter()
    ops = ([dist.P2POp(dist.isend, x, _pod_rank(mesh, p), mesh.pod_group)
            for p, x in out_s]
           + [dist.P2POp(dist.irecv, x, _pod_rank(mesh, p), mesh.pod_group)
              for p, x in in_b])
    for w in dist.batch_isend_irecv(ops):
        w.wait()
    if in_b:
        _sync(in_b[0][1])
    t2 = time.perf_counter()
    got = [x.to(like.device) if staged else x
           for (_, x), (_, like) in zip(in_b, recvs)]
    if got:
        _sync(got[0])
    t3 = time.perf_counter()
    host_s, coll_s = (t1 - t0) + (t3 - t2), t2 - t1
    n = len(out_s) + len(in_b)
    for kind, items in (("send", out_s), ("recv", in_b)):
        for _, x in items:
            # the call's seconds, shared out over its sends and receives
            _log(kind, "pod", x.numel() * x.element_size(), True,
                 host_s / n, coll_s / n)
    return got


def gather_to_lead(t: torch.Tensor, mesh) -> Optional[List[torch.Tensor]]:
    """Every pod's row of ``t`` (this rank's), in pod order, as host
    tensors on the pod group's first rank (pod 0); None on the others.
    One leaf at a time, so the writer never holds a whole-model stack on
    the card.  The identity (a list of ``t`` on the host) on one pod."""
    import torch.distributed as dist
    if mesh.pod == 1:
        return [t.detach().cpu()]
    _sync(t)
    t0 = time.perf_counter()
    staged = _staged(mesh, t)
    x = _host_copy(t) if staged else t.contiguous()
    lead = mesh.pod_index == 0
    parts = ([torch.empty(x.shape, dtype=x.dtype, device=x.device,
                          pin_memory=x.is_pinned()) for _ in range(mesh.pod)]
             if lead else None)
    t1 = time.perf_counter()
    dist.gather(x, parts, dst=_pod_rank(mesh, 0), group=mesh.pod_group)
    _sync(x)
    t2 = time.perf_counter()
    out = None
    if lead:
        # group rank i holds global rank pod_ranks[i]: order by its pod
        order = sorted(range(mesh.pod),
                       key=lambda i: mesh.pod_of(mesh.pod_ranks[i]))
        out = [parts[i].cpu() for i in order]
    t3 = time.perf_counter()
    _log("gather", "pod", t.numel() * t.element_size(), True,
         (t1 - t0) + (t3 - t2), t2 - t1)
    return out


def barrier(mesh) -> None:
    """Every rank of the world (unlogged: it moves no payload)."""
    import torch.distributed as dist
    if dist.is_initialized() and mesh.pod * mesh.data * mesh.model > 1:
        dist.barrier()


def all_reduce_mean(t: torch.Tensor, mesh) -> torch.Tensor:
    """The mean of ``t`` over the mesh's data group (the same tensor on
    every data rank).  The identity on one data rank."""
    import torch.distributed as dist
    if mesh.data == 1:
        return t

    def call(x):
        x = x.clone() if x is t else x       # the caller's tensor stays
        flat, bounds = _pieces(x)
        for w in [dist.all_reduce(flat[a:b], op=dist.ReduceOp.SUM,
                                  group=mesh.data_group, async_op=True)
                  for a, b in bounds]:
            w.wait()
        return [x.div_(mesh.data)]

    return _run(mesh, t, "all-reduce", "data", mesh.spans_pods, call)


def all_reduce_model(t: torch.Tensor, mesh, op: str = "sum") -> torch.Tensor:
    """The SUM (``op`` "sum") or MAX ("max") of ``t`` over the mesh's model
    group, the same tensor on every model rank (a new one: ``t`` is not
    written).  Logged on the ``model`` axis, not crossing pods.  The
    identity on one model rank."""
    import torch.distributed as dist
    if mesh.model == 1:
        return t
    red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]

    def call(x):
        x = x.clone(memory_format=torch.contiguous_format) if x is t else x
        flat, bounds = _pieces(x)
        for w in [dist.all_reduce(flat[a:b], op=red, group=mesh.model_group,
                                  async_op=True) for a, b in bounds]:
            w.wait()
        return [x]

    return _run(mesh, t, "all-reduce", "model", False, call)


def all_gather_model(t: torch.Tensor, dim: int, mesh) -> torch.Tensor:
    """Every model rank's ``t`` (equal shapes) joined along ``dim``, in
    model-index order (group rank = model index: the group's ranks
    ascend with it).  Logged on the ``model`` axis.  The identity on one
    model rank."""
    import torch.distributed as dist
    if mesh.model == 1:
        return t

    def call(x):
        x = x.contiguous()
        parts = [torch.empty(x.shape, dtype=x.dtype, device=x.device,
                             pin_memory=x.is_pinned())
                 for _ in range(mesh.model)]
        dist.all_gather(parts, x, group=mesh.model_group)
        return [torch.cat(parts, dim=dim)]

    return _run(mesh, t, "all-gather", "model", False, call)


def gather_model(t: torch.Tensor, dim: int, mesh) -> Optional[torch.Tensor]:
    """``all_gather_model``'s join at the model group's first rank (model
    index 0) alone; None at the others.  Logged on the ``model`` axis.
    ``t`` itself on one model rank."""
    import torch.distributed as dist
    if mesh.model == 1:
        return t
    lead = mesh.model_index == 0

    def call(x):
        x = x.contiguous()
        parts = ([torch.empty(x.shape, dtype=x.dtype, device=x.device,
                              pin_memory=x.is_pinned())
                  for _ in range(mesh.model)] if lead else None)
        dist.gather(x, parts, group=mesh.model_group, dst=mesh.rank_of(
            mesh.pod_index, mesh.data_index, 0))
        return [torch.cat(parts, dim=dim)] if lead else [t]

    out = _run(mesh, t, "gather", "model", False, call)
    return out if lead else None


def reduce_scatter_data(t: torch.Tensor, dim: int, mesh) -> torch.Tensor:
    """The mean of ``t`` over the mesh's data group, this rank's
    contiguous piece along ``dim`` (data index i holds the i-th of
    ``data`` equal pieces): one reduce-scatter of the SUM, divided by the
    data count as ``all_reduce_mean`` divides it.  Logged as
    ``reduce-scatter`` on the ``data`` axis, with ``t``'s bytes.  ``t``
    itself on one data rank."""
    import torch.distributed as dist
    if mesh.data == 1:
        return t

    def call(x):
        chunks = [c.contiguous() for c in x.chunk(mesh.data, dim=dim)]
        out = torch.empty(chunks[0].shape, dtype=x.dtype, device=x.device,
                          pin_memory=x.is_pinned())
        flat, bounds = _pieces(out)
        ins = [c.reshape(-1) for c in chunks]
        for w in [dist.reduce_scatter(flat[a:b], [c[a:b] for c in ins],
                                      op=dist.ReduceOp.SUM,
                                      group=mesh.data_group, async_op=True)
                  for a, b in bounds]:
            w.wait()
        return [out.div_(mesh.data)]

    return _run(mesh, t, "reduce-scatter", "data", mesh.spans_pods, call)


def all_gather_data(t: torch.Tensor, dim: int, mesh) -> torch.Tensor:
    """Every data rank's ``t`` (equal shapes) joined along ``dim``, in
    data-index order (group rank = data index: the group's ranks ascend
    with it).  Logged on the ``data`` axis.  ``t`` itself on one data
    rank."""
    import torch.distributed as dist
    if mesh.data == 1:
        return t

    def call(x):
        parts = [torch.empty(x.shape, dtype=x.dtype, device=x.device,
                             pin_memory=x.is_pinned())
                 for _ in range(mesh.data)]
        flat, bounds = _pieces(x.contiguous())
        outs = [p.reshape(-1) for p in parts]
        for w in [dist.all_gather([o[a:b] for o in outs], flat[a:b],
                                  group=mesh.data_group, async_op=True)
                  for a, b in bounds]:
            w.wait()
        return [torch.cat(parts, dim=dim)]

    return _run(mesh, t, "all-gather", "data", mesh.spans_pods, call)


def all_reduce_data(t: torch.Tensor, mesh, op: str = "sum") -> torch.Tensor:
    """The SUM (``op`` "sum") or MAX ("max") of ``t`` over the mesh's data
    group, the same tensor on every data rank (a new one).  Logged on the
    ``data`` axis.  ``t`` itself on one data rank."""
    import torch.distributed as dist
    if mesh.data == 1:
        return t
    red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]

    def call(x):
        x = x.clone(memory_format=torch.contiguous_format) if x is t else x
        dist.all_reduce(x, op=red, group=mesh.data_group)
        return [x]

    return _run(mesh, t, "all-reduce", "data", mesh.spans_pods, call)
