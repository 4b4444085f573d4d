"""The port's collectives, each one logged: the counterpart of the JAX
package's ``launch/hlo_analysis.py weighted_collective_stats`` and
``launch/dryrun_lib.py hlo_collective_stats``.  Those parse the
collectives out of XLA's compiled program; eager PyTorch has no program
to parse, so the port counts the collectives it issues instead.

Every collective of the port goes through the two wrappers here:

* ``all_gather_rows(t, mesh)`` — over the mesh's pod group: this rank's
  (1, ...) row in, the (P, ...) rows of every pod out, stacked in POD
  order (the replicate hop of the outer step);
* ``all_reduce_mean(t, mesh)`` — over the mesh's data group: the mean of
  the data ranks' tensors (DDP's gradient all-reduce).

Each call appends a ``CollectiveRecord``: the op kind (the reference's
names, ``all-gather`` / ``all-reduce``), the mesh axis, the bytes THIS
rank sends (its operand: the one-process transport's ``shipped`` counts
each worker's payload once, and so does this), whether the group crosses
a pod boundary, and the seconds spent.  Under ``gloo`` a CUDA tensor is
staged to the host around the call (gloo has no CUDA all-gather),
through pinned memory (copies several times faster than to pageable
memory); the staging is explicit and timed apart (``host_s``), and the
collective itself is ``coll_s``.  CUDA work is synchronized before a
call, so neither time includes compute enqueued before it.  A large
tensor goes as up to ``MAX_PIECES`` pieces of about ``PIECE_BYTES``,
issued together (gloo serves the pieces on its threads at once; one
1 GiB piece runs slower); the record is the call's.

``collective_stats()`` sums the log into the reference's keys
(``bytes_by_kind``, ``count_by_kind``, ``wire_bytes_per_device``, where an
all-reduce counts twice, as a ring all-reduce moves about twice its
payload, and ``cross_pod_bytes_per_device``); ``scope(name)`` tags the
records made inside it (for example the inner steps apart from the outer
rounds) and ``reset_log()`` clears the log.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, List, Optional

import torch

PIECE_BYTES = 32 * 2 ** 20
MAX_PIECES = 32


@dataclasses.dataclass(frozen=True)
class CollectiveRecord:
    kind: str            # "all-gather" | "all-reduce"
    axis: str            # the mesh axis: "pod" | "data"
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


def collective_stats(scope: Optional[str] = None) -> Dict:
    """The log summed into the reference's collective-statistics keys (per
    device = per rank), plus the seconds staged and spent."""
    by_kind: Dict[str, int] = {}
    count: Dict[str, int] = {}
    wire = cross = 0
    host_s = coll_s = 0.0
    for r in records(scope):
        by_kind[r.kind] = by_kind.get(r.kind, 0) + r.nbytes
        count[r.kind] = count.get(r.kind, 0) + 1
        b = r.nbytes * (2 if r.kind == "all-reduce" else 1)
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
    x = (torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t)
         if staged else t)
    t1 = time.perf_counter()
    parts = call(x)
    _sync(parts[0])
    t2 = time.perf_counter()
    if staged:
        parts = [p.to(t.device) for p in parts]
    out = parts[0] if len(parts) == 1 else torch.cat(parts)
    _sync(out)
    t3 = time.perf_counter()
    _LOG.append(CollectiveRecord(
        kind=kind, axis=axis, nbytes=t.numel() * t.element_size(),
        cross_pod=cross, host_s=(t1 - t0) + (t3 - t2), coll_s=t2 - t1,
        scope=_SCOPE[-1]))
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
                       key=lambda i: mesh.pod_ranks[i] // mesh.data)
        return [parts[i] for i in order]

    return _run(mesh, t, "all-gather", "pod", True, call)


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

    return _run(mesh, t, "all-reduce", "data", False, call)
