"""Codec-aware outer-sync transport (the JAX package's
``core/transport.py``): what crosses the slow link in a sync round.

    delta (f32, stacked (K, ...) per worker)
      -> Codec.encode   -> OuterPayload (wire-dtype data + scales)
      -> Transport.ship -> the same payload on every worker
      -> Codec.decode   -> f32, averaged by the outer optimizer.

Payloads are flat dicts ``{parameter path: (K, ...) tensor}``.  The outer
step (``core/outer_opt.py``) hands the transport one leaf at a time, so a
payload holds one leaf's K rows and never the whole model's.

Wire format of an ``OuterPayload``: ``data`` in the codec's wire dtype
(f32 / bf16 / int8 / fp8 e4m3 / fp8 e5m2), leading K worker dim intact;
``scales`` None or per-tensor-per-worker f32 scales shaped ``(K, 1, ...,
1)``; ``kind`` / ``codec`` / ``fragment`` routing metadata.

A ``Codec`` has ``name`` (wire id), ``width`` (wire bytes per element),
``lossy``, ``encode(delta, residual=None, kind=, fragment=) ->
(OuterPayload, new_residual)`` — with a residual it quantizes ``e = delta
+ residual`` and returns ``e - decode(payload)`` (error feedback: what
fails to cross the wire this round is retried next round) — and
``decode(payload) -> f32``.

``Int8Symmetric`` and ``Fp8Codec`` run the hand-written quantize and
dequantize kernels (``repro_torch.kernels.quantize``) on CUDA tensors and
their plain versions on CPU tensors.  ``BF16Cast`` is a plain cast, as in
the reference (no kernel there either).

Tensor parallelism (a process mesh with ``model`` > 1, the
``replicate_fn``'s ``tp``): each rank's rows are its shards of the
worker's leaves.  ``Transport`` hands that mesh to the codec
(``encode(axis=)``), and ``QuantizedCodec.encode`` reduces a split leaf's
per-row amax over the model group (MAX) between the quantize kernel's
two passes, so the scale is the whole leaf's on every model rank and
the codes are the one-process codes' slices; the replicate hop gathers
each rank's shard rows over its pod group (the reference's multi-pod
outer step keeps each leaf's model shards the same way); a whole leaf
is shipped by every model rank, as every device of the reference's
model axis ships it.

``shipped`` counts the wire bytes of every payload shipped, per codec
name, since ``reset_shipped()`` — the per-sync wire-bytes metric: the
bytes this process ships.  On one card that is every worker's payload;
as one rank of a process mesh (a ``replicate_fn``, below) it is this
rank's own row (none when a quorum round counts it out), so the ranks'
counts sum to the one-process count.  The gossip hop (``ship_peers`` /
``exchange_peers``, and ``ship_rows`` for the peer's f32 outer state)
counts only the rows that cross a link: worker i receives row
``peer_idx[i]``, and a self-paired worker receives nothing; across ranks
a rank counts the rows it sends, point to point.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

Flat = Dict[str, torch.Tensor]

# wire width (bytes/element) per codec name — the single source of truth
# for every byte-accounting path (schedules, reports)
WIRE_WIDTH = {"f32": 4, "bf16": 2, "int8": 1, "fp8": 1, "fp8_e5m2": 1}

# config spellings -> canonical codec names ("fp8" is the e4m3 flavor)
_ALIASES = {"float32": "f32", "f32": "f32",
            "bfloat16": "bf16", "bf16": "bf16",
            "int8": "int8",
            "fp8": "fp8", "float8": "fp8", "e4m3": "fp8",
            "fp8_e4m3": "fp8",
            "e5m2": "fp8_e5m2", "fp8_e5m2": "fp8_e5m2"}

# the byte carrier of each narrow wire across the replicate hop: a payload
# crosses as its bytes (gloo takes neither int16 nor float8 tensors)
_WIRE_BYTES = ("bf16", "fp8", "fp8_e5m2")

# codec name -> wire bytes shipped since reset_shipped()
shipped: collections.Counter = collections.Counter()


def reset_shipped() -> None:
    shipped.clear()


def ranked(replicate_fn) -> bool:
    """Whether ``replicate_fn`` makes this process one rank of a process
    mesh: it names the worker rows this process holds (``rows``;
    ``launch.mesh.PodReplicate``)."""
    return getattr(replicate_fn, "rows", None) is not None


def _nbytes(tree: Optional[Flat]) -> int:
    if tree is None:
        return 0
    return sum(t.numel() * t.element_size() for t in tree.values())


def _crossing(peer_idx: Sequence[int]) -> int:
    """Rows of a peer gather that cross a link (worker i reads row
    ``peer_idx[i]``; a self-paired worker reads its own)."""
    return sum(1 for i, p in enumerate(peer_idx) if p != i)


def _gather_rows(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows ``idx`` of a stacked (K, ...) tensor, in its own dtype; fp8
    codes move as their bytes (``uint8``), as the reference bitcasts them
    around its gather."""
    if t.dtype in (torch.float8_e4m3fn, torch.float8_e5m2):
        return t.view(torch.uint8).index_select(0, idx).view(t.dtype)
    return t.index_select(0, idx)


@dataclasses.dataclass
class OuterPayload:
    """One encoded cross-worker payload (see the module docstring)."""
    data: Flat
    scales: Optional[Flat] = None
    kind: str = "delta"            # "delta" | "fragment" | "grads"
    codec: str = "f32"
    fragment: int = -1

    def nbytes(self) -> int:
        """Wire bytes of all K rows: tensor payload + scale sideband."""
        return _nbytes(self.data) + _nbytes(self.scales)


class Codec:
    """Base codec: lossless identity semantics; subclasses override
    ``_enc`` / ``_dec`` (and ``encode`` for the fused quantize path)."""
    name = "f32"
    lossy = False

    @property
    def width(self) -> int:
        """Wire bytes per element (from the shared ``WIRE_WIDTH``)."""
        return WIRE_WIDTH[self.name]

    def _enc(self, e: Flat) -> Tuple[Flat, Optional[Flat]]:
        return e, None

    def _dec(self, data: Flat, scales: Optional[Flat]) -> Flat:
        return {k: v.float() for k, v in data.items()}

    def encode(self, delta: Flat, residual: Optional[Flat] = None,
               kind: str = "delta", fragment: int = -1, axis=None
               ) -> Tuple[OuterPayload, Optional[Flat]]:
        """``axis``: the mesh axes the leaves are split over (a process
        mesh whose model axis or ``fsdp`` splits them), or None; an
        elementwise codec ignores it."""
        e = (delta if residual is None else
             {k: d.float() + residual[k] for k, d in delta.items()})
        data, scales = self._enc(e)
        payload = OuterPayload(data=data, scales=scales, kind=kind,
                               codec=self.name, fragment=fragment)
        new_residual = None
        if residual is not None:
            dq = self._dec(data, scales)
            new_residual = {k: e[k] - dq[k] for k in e}
        return payload, new_residual

    def decode(self, payload: OuterPayload) -> Flat:
        return self._dec(payload.data, payload.scales)

    def schedule_bytes(self, n_elems: int) -> int:
        """Wire bytes for ``n_elems`` payload elements (per worker)."""
        return self.width * n_elems


@dataclasses.dataclass(frozen=True)
class F32Passthrough(Codec):
    name = "f32"
    lossy = False


@dataclasses.dataclass(frozen=True)
class BF16Cast(Codec):
    """Round-to-nearest-even bf16 cast; lossy in general, so error
    feedback applies when a residual is carried."""
    name = "bf16"
    lossy = True

    def _enc(self, e):
        return {k: v.to(torch.bfloat16) for k, v in e.items()}, None


@dataclasses.dataclass(frozen=True)
class QuantizedCodec(Codec):
    """Symmetric narrow-dtype codecs: q = e / s (rounded for int8),
    s = amax / QMAX per tensor per worker.  ``encode`` runs the fused
    quantize + residual kernel whether or not a residual is carried (the
    residual output is dropped without one).  Subclasses pick
    ``qdtype``."""
    lossy = True

    @property
    def qdtype(self) -> str:
        return "int8"

    def encode(self, delta, residual=None, kind="delta", fragment=-1,
               axis=None):
        from repro_torch.kernels import quantize as qz
        data, scales, new_res = {}, {}, {}
        for k, d in delta.items():
            # a shard's amax, maxed over every group that splits the leaf:
            # the whole leaf's scale
            hook = (None if axis is None or not axis.splits(k) else
                    lambda a, k=k: axis.reduce_leaves([k], [a], "max")[0])
            data[k], new_res[k], scales[k] = qz.quantize_ef(
                d, None if residual is None else residual[k],
                dtype=self.qdtype, amax_reduce=hook)
        payload = OuterPayload(data=data, scales=scales, kind=kind,
                               codec=self.name, fragment=fragment)
        return payload, (new_res if residual is not None else None)

    def _dec(self, data, scales):
        from repro_torch.kernels import quantize as qz
        return {k: qz.dequantize(q, scales[k]) for k, q in data.items()}


@dataclasses.dataclass(frozen=True)
class Int8Symmetric(QuantizedCodec):
    """Per-tensor-per-worker symmetric int8: q = round(e / s), s = amax/127."""
    name = "int8"


@dataclasses.dataclass(frozen=True)
class Fp8Codec(QuantizedCodec):
    """Per-tensor-per-worker scaled fp8 cast: q = cast(e / s), s =
    amax/QMAX; ``flavor`` "e4m3" (default) or "e5m2".  Values are clipped
    to ±QMAX before the cast (e4m3fn has no inf)."""
    flavor: str = "e4m3"

    @property
    def name(self) -> str:                  # type: ignore[override]
        return "fp8" if self.flavor == "e4m3" else "fp8_e5m2"

    @property
    def qdtype(self) -> str:
        return "fp8_e4m3" if self.flavor == "e4m3" else "fp8_e5m2"


def make_codec(dtype: str) -> Codec:
    """Codec for a config ``delta_dtype`` spelling
    (float32/bfloat16/int8/fp8/e5m2 and friends)."""
    name = _ALIASES.get(dtype)
    if name == "f32":
        return F32Passthrough()
    if name == "bf16":
        return BF16Cast()
    if name == "int8":
        return Int8Symmetric()
    if name == "fp8":
        return Fp8Codec(flavor="e4m3")
    if name == "fp8_e5m2":
        return Fp8Codec(flavor="e5m2")
    raise ValueError(f"unknown delta dtype {dtype!r}; "
                     f"expected one of {sorted(_ALIASES)}")


def wire_width(dtype: str) -> int:
    return WIRE_WIDTH[_ALIASES[dtype]]


def _as_bytes(t: torch.Tensor) -> torch.Tensor:
    """A (R, ...) tensor's bytes as (R, nbytes / R) uint8 (a bitcast)."""
    return t.reshape(t.shape[0], -1).view(torch.uint8)


def _from_bytes(b: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Inverse of ``_as_bytes`` for every row of ``b``: rows shaped and
    typed as ``like``'s."""
    return b.view(like.dtype).reshape((b.shape[0],) + tuple(like.shape[1:]))


@dataclasses.dataclass(frozen=True)
class Transport:
    """Codec + the replicate hop: everything between "delta captured" and
    "f32 delta available on every worker".  ``replicate_fn`` (None on one
    card) maps ``{path: this process's rows}`` to ``{path: every worker's
    rows}`` in worker order: the all-gather across pods of a process mesh
    (``launch.mesh.ProcessMesh.replicate_fn``)."""
    codec: Codec
    replicate_fn: Optional[Callable] = None

    def ship(self, payload: OuterPayload,
             sources: Optional[Sequence[int]] = None) -> OuterPayload:
        """The replicate hop; counts this process's payload in
        ``shipped``.  On one card every worker's rows already sit in the
        same memory, so shipping is the identity.  With a ``replicate_fn``
        the ENCODED rows and their scales cross, as the reference's pod
        mesh gathers them: a narrow wire (bf16, fp8, e5m2) as its bytes
        (``uint8``, a bitcast each way), so only wire-dtype bytes move.
        The reference's optimization barrier keeps XLA from widening the
        wire; eager PyTorch has no such rewrite to guard against.

        ``sources`` (a process mesh only: a quorum round's contributors,
        ascending) names the workers whose rows cross: the result holds
        theirs alone, in that order, and a rank whose row is not among
        them ships (and counts) nothing."""
        if sources is None or not ranked(self.replicate_fn):
            shipped[payload.codec] += payload.nbytes()
        else:
            n = next(iter(payload.data.values())).shape[0]
            shipped[payload.codec] += (payload.nbytes() // n * sum(
                w in sources for w in self.replicate_fn.rows))
        if self.replicate_fn is None:
            return payload
        hop = (self.replicate_fn if sources is None else
               lambda flat: self.replicate_fn(flat, sources))
        data = payload.data
        if payload.codec in _WIRE_BYTES:
            data = {k: _as_bytes(v) for k, v in data.items()}
        data = hop(data)
        if payload.codec in _WIRE_BYTES:
            data = {k: _from_bytes(v, payload.data[k])
                    for k, v in data.items()}
        scales = None if payload.scales is None else hop(payload.scales)
        return dataclasses.replace(payload, data=data, scales=scales)

    def _peer_hop(self, t: torch.Tensor, peer_idx: Sequence[int]
                  ) -> Tuple[torch.Tensor, int]:
        """Across ranks: this rank's (1, ...) row ``t`` to each worker
        that reads it, the row it reads back (``PodReplicate.peer_rows``;
        a fresh copy of ``t`` when it reads its own), narrow dtypes as
        their bytes.  Returns (row, rows sent)."""
        narrow = t.dtype in (torch.bfloat16, torch.float8_e4m3fn,
                             torch.float8_e5m2)
        b = _as_bytes(t) if narrow else t
        got, nbytes = self.replicate_fn.peer_rows(b, peer_idx)
        if got is None:
            got = t.clone()
        elif narrow:
            got = _from_bytes(got, t)
        return got, nbytes // (t.numel() * t.element_size())

    def ship_peers(self, payload: OuterPayload,
                   peer_idx: Sequence[int]) -> OuterPayload:
        """The gossip hop: worker i receives only row ``peer_idx[i]`` of
        the stacked payload — one peer payload per worker instead of the
        (K-1)-row gather, which keeps gossip's traffic flat in fleet size.
        The gather runs on the ENCODED payload, codes in the wire dtype
        and their scales; decoding comes after.  On one card it is a
        local ``index_select`` over dim 0, and ``shipped`` counts one
        payload row (codes and scales) per worker whose peer is another
        worker.  Across ranks (a ``replicate_fn``) each rank holds its
        own row and the hop is point-to-point sends and receives
        (``PodReplicate.peer_rows``); ``shipped`` counts the rows this
        rank sends, so the ranks' counts sum to the one-card count."""
        if self.replicate_fn is not None:
            data, scales, sent = {}, None, 0
            for k, v in payload.data.items():
                data[k], sent = self._peer_hop(v, peer_idx)
            if payload.scales is not None:
                scales = {k: self._peer_hop(v, peer_idx)[0]
                          for k, v in payload.scales.items()}
            shipped[payload.codec] += payload.nbytes() * sent
            return dataclasses.replace(payload, data=data, scales=scales)
        some = next(iter(payload.data.values()))
        idx = torch.as_tensor(list(peer_idx), dtype=torch.long,
                              device=some.device)
        data = {k: _gather_rows(v, idx) for k, v in payload.data.items()}
        scales = (None if payload.scales is None else
                  {k: v.index_select(0, idx)
                   for k, v in payload.scales.items()})
        shipped[payload.codec] += (payload.nbytes() // len(peer_idx)
                                   * _crossing(peer_idx))
        return dataclasses.replace(payload, data=data, scales=scales)

    def ship_rows(self, t: torch.Tensor,
                  peer_idx: Sequence[int]) -> torch.Tensor:
        """Rows ``peer_idx[i]`` of a stacked (K, ...) f32 tensor for each
        worker i: the peer's outer state that gossip's pair mean reads
        (anchors, momentum).  Counted in ``shipped`` like ``ship_peers``;
        across ranks ``t`` is this rank's row and the hop is
        ``ship_peers``'."""
        row_nbytes = t[0].numel() * t.element_size()
        if self.replicate_fn is not None:
            got, sent = self._peer_hop(t, peer_idx)
            shipped["f32"] += row_nbytes * sent
            return got
        idx = torch.as_tensor(list(peer_idx), dtype=torch.long,
                              device=t.device)
        shipped["f32"] += row_nbytes * _crossing(peer_idx)
        return _gather_rows(t, idx)

    def exchange(self, stacked_delta: Flat, residual: Optional[Flat] = None,
                 kind: str = "delta", fragment: int = -1,
                 sources: Optional[Sequence[int]] = None
                 ) -> Tuple[Flat, Optional[Flat]]:
        """encode -> ship -> decode; returns (f32 stacked delta, new
        error-feedback residual or None).  ``sources``: ``ship``'s."""
        payload, new_residual = self.codec.encode(
            stacked_delta, residual, kind=kind, fragment=fragment,
            axis=getattr(self.replicate_fn, "sharded", None))
        payload = self.ship(payload, sources)
        return self.codec.decode(payload), new_residual

    def exchange_peers(self, stacked_delta: Flat, peer_idx: Sequence[int],
                       residual: Optional[Flat] = None, kind: str = "delta",
                       fragment: int = -1
                       ) -> Tuple[Flat, Flat, Optional[Flat]]:
        """Peer-pair exchange: encode -> ship one peer row per worker ->
        decode.  Returns ``(dq_own, dq_peer, new_residual)``: ``dq_own[i]``
        is worker i's own decoded delta, ``dq_peer[i]`` worker
        ``peer_idx[i]``'s.  The delta is dropped once encoded (pass it
        unnamed to free it here)."""
        payload, new_residual = self.codec.encode(
            stacked_delta, residual, kind=kind, fragment=fragment,
            axis=getattr(self.replicate_fn, "sharded", None))
        del stacked_delta
        peer_payload = self.ship_peers(payload, peer_idx)
        return (self.codec.decode(payload), self.codec.decode(peer_payload),
                new_residual)
