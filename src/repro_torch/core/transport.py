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

``shipped`` counts the wire bytes of every payload shipped, per codec
name, since ``reset_shipped()`` — the per-sync wire-bytes metric.  The
gossip hop (``ship_peers`` / ``exchange_peers``, and ``ship_rows`` for the
peer's f32 outer state) counts only the rows that cross a link: worker i
receives row ``peer_idx[i]``, and a self-paired worker receives nothing.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Dict, Optional, Sequence, Tuple

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

# codec name -> wire bytes shipped since reset_shipped()
shipped: collections.Counter = collections.Counter()


def reset_shipped() -> None:
    shipped.clear()


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
               kind: str = "delta", fragment: int = -1
               ) -> Tuple[OuterPayload, Optional[Flat]]:
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

    def encode(self, delta, residual=None, kind="delta", fragment=-1):
        from repro_torch.kernels import quantize as qz
        data, scales, new_res = {}, {}, {}
        for k, d in delta.items():
            data[k], new_res[k], scales[k] = qz.quantize_ef(
                d, None if residual is None else residual[k],
                dtype=self.qdtype)
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


@dataclasses.dataclass(frozen=True)
class Transport:
    """Codec + the replicate hop: everything between "delta captured" and
    "f32 delta available on every worker"."""
    codec: Codec

    def ship(self, payload: OuterPayload) -> OuterPayload:
        """The replicate hop.  On one card every worker's rows already sit
        in the same memory, so shipping is the identity; it counts the
        payload's wire bytes in ``shipped``.  The reference's bitcast and
        optimization-barrier games keep XLA from widening the wire on a
        pod mesh; eager PyTorch has no such rewrite to guard against."""
        shipped[payload.codec] += payload.nbytes()
        return payload

    def ship_peers(self, payload: OuterPayload,
                   peer_idx: Sequence[int]) -> OuterPayload:
        """The gossip hop: worker i receives only row ``peer_idx[i]`` of
        the stacked payload — one peer payload per worker instead of the
        (K-1)-row gather, which keeps gossip's traffic flat in fleet size.
        The gather runs on the ENCODED payload, codes in the wire dtype
        and their scales; decoding comes after.  On one card it is a
        local ``index_select`` over dim 0.  ``shipped`` counts one payload
        row (codes and scales) per worker whose peer is another worker."""
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

    def ship_rows(self, t: torch.Tensor, peer_idx: Sequence[int], *,
                  codec: str = "f32",
                  row_nbytes: Optional[int] = None) -> torch.Tensor:
        """Rows ``peer_idx[i]`` of a stacked (K, ...) tensor for each
        worker i: the peer's outer state that gossip's pair mean reads
        (anchors, momentum; f32 on the wire), or a publication on the
        async board, which holds it decoded while the link carries it
        encoded (``codec`` and its ``row_nbytes``).  Counted in
        ``shipped`` like ``ship_peers``."""
        idx = torch.as_tensor(list(peer_idx), dtype=torch.long,
                              device=t.device)
        if row_nbytes is None:
            row_nbytes = t[0].numel() * t.element_size()
        shipped[codec] += row_nbytes * _crossing(peer_idx)
        return _gather_rows(t, idx)

    def exchange(self, stacked_delta: Flat, residual: Optional[Flat] = None,
                 kind: str = "delta", fragment: int = -1
                 ) -> Tuple[Flat, Optional[Flat]]:
        """encode -> ship -> decode; returns (f32 stacked delta, new
        error-feedback residual or None)."""
        payload, new_residual = self.codec.encode(
            stacked_delta, residual, kind=kind, fragment=fragment)
        payload = self.ship(payload)
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
            stacked_delta, residual, kind=kind, fragment=fragment)
        del stacked_delta
        peer_payload = self.ship_peers(payload, peer_idx)
        return (self.codec.decode(payload), self.codec.decode(peer_payload),
                new_residual)
