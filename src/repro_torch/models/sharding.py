"""Logical-axis sharding rules (the JAX package's ``models/sharding.py``).

Tensors are described by *logical* dim names; a rules table maps each
logical name to zero or more mesh axes.  ``spec_for`` resolves a tuple of
names to a partition spec on a mesh, dropping a mapping whose mesh-axis
product does not divide the tensor dim (25 attention heads over an 8-way
``model`` axis stay whole) and using each mesh axis at most once.  The
spec is a tuple with the entries of the reference's ``PartitionSpec``:
None, an axis name, or a tuple of axis names.  ``local_shape`` gives the
shard's shape on one device.

The mesh is anything with a ``shape`` dict of axis -> size
(``launch.mesh.MeshShape``).  The port's dry run resolves its abstract
states with these rules.  The reference's ``logical_constraint`` (a
``with_sharding_constraint`` inside jit) has no meaning in eager PyTorch,
which has no partitioner to hint, so there is none here.

The runtime layout over the ``model`` axis of a process mesh.  Eager
PyTorch splits by hand what XLA's partitioner splits for the reference
(``models/tensor_parallel.py``).  ``tp_layout(cfg, model)`` maps each
parameter leaf to the dim it is split on over ``model`` ranks, or None
(whole on every rank): the dim ``spec_for`` shards over ``model``, with
one rule more, because the port's attention runs whole heads: a
``heads`` / ``kv_heads`` dim splits only where ``num_heads`` and
``num_kv_heads`` both divide by ``model`` (at ``model`` 4 ``spec_for``
splits d20's (1280, 1280) ``wq``, 10 heads of 128, into 320-column
pieces, which cut heads in half); otherwise attention's leaves stay
whole, as the reference's ``attn_dp`` profile keeps them.  The qkv biases split with
their heads (the reference's rules name no dim of theirs).  Dims are
counted from the END of the leaf (-1 the last), so the same entry
addresses a leaf, its optimizer moments and a (K, ...) stack of it.
``shard`` cuts one-process flat parameters to a rank's shards,
``gather`` joins the ranks' shards back, and ``split_of`` finds a
leaf's entry from any path that ends in the leaf's (a checkpoint's
``worker_params/0/layers/attn/wq``).

The runtime layout over the ``data`` axis (ZeRO-3, the reference's
``"fsdp": ("data",)`` rule, which its "2d" and ``dp_fsdp`` profiles
train under).  ``fsdp_layout(cfg, data, model)`` maps each leaf to the
dim its ``fsdp`` name resolves to over ``data`` under the default rules
(``spec_for`` on a (data, model) mesh: the d_model dim of every matrix,
where ``data`` divides it), or None: the 1-D leaves (norm scales,
biases) stay whole.  Under (data, model) a leaf may split on two dims:
d20's ``wq`` (stack, d, nq) splits d over ``data`` and nq over
``model``, ``embed/table`` (vocab, d) vocab over ``model`` and d over
``data``.  Its dims count from the end too.  ``shard`` and ``gather``
take both layouts (``fsdp=``, ``data=``): a rank's shard is its model
piece of its data piece, and ``gather(shard(p)) == p`` exactly.

Serving over ``model`` (the reference's dry run of its serve step,
``launch/state.py`` ``tp_kv_repeat`` and ``launch/dryrun_lib.py``'s
``kv_seq`` rule), decided from the config and ``model`` alone
(``serve_layout``):

* ``"heads"``: after ``tp_kv_repeat`` both head counts divide by
  ``model``.  Each rank holds a contiguous run of the KV heads with their
  query groups (``tp_layout`` of the repeated config) and those heads of
  the ring cache, (L, B, KV / model, cap, hd), ``pos`` whole.  Where the
  repeat applies, ``repeat_kv_heads`` repeats ``wk`` / ``wv`` (and their
  biases) to match, and the repeated config computes the original
  model's function.
* ``"kv_seq"``: the KV heads still do not divide.  Attention stays whole
  on every rank (``tp_layout``); rank r holds the ring slots [r cap /
  model, (r + 1) cap / model) of k / v and ``pos``, and the shared write
  index.  The softmax reduces over the ranks' slots
  (``tensor_parallel.seq_parallel_attention``).

The MLP and the vocab split as in training, either way.  ``shard_cache`` /
``gather_cache`` cut a one-process ring cache into the ranks' parts and
join them back.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

MeshAxes = Union[None, str, Tuple[str, ...]]
Spec = Tuple[MeshAxes, ...]

# default logical -> mesh rules for the production meshes; "pod" appears
# only in the multi-pod mesh, and axes a mesh lacks are dropped
DEFAULT_RULES: Dict[str, Tuple[str, ...]] = {
    "batch": ("pod", "data"),       # data parallel (DiLoCo worker = pod)
    "fsdp": ("data",),              # parameter dim sharded ZeRO-3 style
    "model": ("model",),            # tensor parallel
    "vocab": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "ffn": ("model",),
    "expert": (),                   # experts replicated (FSDP on inner dims)
    "seq": (),                      # sequence not sharded
    "stack": (),                    # stacked layer dim
    "state": (),
}


class _Ctx(threading.local):
    def __init__(self):
        self.mesh = None
        self.rules: Dict[str, Tuple[str, ...]] = dict(DEFAULT_RULES)


_CTX = _Ctx()


@contextlib.contextmanager
def sharding_ctx(mesh, rules: Optional[Dict[str, Tuple[str, ...]]] = None):
    """Activate a mesh and logical rules (the defaults updated by
    ``rules``) for the code inside."""
    prev_mesh, prev_rules = _CTX.mesh, _CTX.rules
    _CTX.mesh = mesh
    _CTX.rules = dict(DEFAULT_RULES)
    if rules:
        _CTX.rules.update(rules)
    try:
        yield
    finally:
        _CTX.mesh, _CTX.rules = prev_mesh, prev_rules


def active_mesh():
    return _CTX.mesh


def _mesh_axes_for(logical: Optional[str], mesh) -> Tuple[str, ...]:
    if logical is None:
        return ()
    axes = _CTX.rules.get(logical, ())
    if isinstance(axes, str):
        axes = (axes,)
    return tuple(a for a in axes if a in mesh.shape)


def spec_for(dim_names: Sequence[Optional[str]],
             dims: Optional[Sequence[int]] = None, mesh=None) -> Spec:
    """Resolve logical dim names to a partition spec (a tuple), enforcing
    divisibility by ``dims`` when given; () without a mesh."""
    mesh = mesh or _CTX.mesh
    if mesh is None:
        return ()
    out = []
    used: set = set()
    for i, name in enumerate(dim_names):
        axes = tuple(a for a in _mesh_axes_for(name, mesh) if a not in used)
        if axes and dims is not None:
            prod = 1
            for a in axes:
                prod *= mesh.shape[a]
            if dims[i] % prod != 0:
                axes = ()
        used.update(axes)
        if not axes:
            out.append(None)
        elif len(axes) == 1:
            out.append(axes[0])
        else:
            out.append(tuple(axes))
    return tuple(out)


def local_shape(shape: Sequence[int], spec: Spec, mesh) -> Tuple[int, ...]:
    """The shape of one device's shard of ``shape`` under ``spec`` (dims
    past the spec's length are whole)."""
    out = []
    for i, n in enumerate(shape):
        axes = spec[i] if i < len(spec) else None
        if axes is None:
            out.append(int(n))
            continue
        prod = 1
        for a in ((axes,) if isinstance(axes, str) else axes):
            prod *= mesh.shape[a]
        out.append(int(n) // prod)
    return tuple(out)


# ---------------------------------------------------------------------------
# The runtime layout over a process mesh's ``model`` axis
# ---------------------------------------------------------------------------

Layout = Mapping[str, Optional[int]]

# the families tensor parallelism splits by hand (ROADMAP §1 lists the rest)
TP_FAMILIES = ("dense",)
_HEAD_NAMES = ("heads", "kv_heads")
_QKV_BIAS = {"attn/bq": "attn/wq", "attn/bk": "attn/wk",
             "attn/bv": "attn/wv"}


class _AxisShape:
    def __init__(self, model: int, data: int = 1):
        self.shape = {"data": data, "model": model}


def require_tp_family(cfg, axis: str = "tensor parallelism over the "
                      "model axis") -> None:
    """Refuse, by name, a config whose family the port does not yet split
    over a mesh axis (``axis`` names the split): MoE, SSM, hybrid,
    encoder-decoder and VLM wait for a later slice (ROADMAP §1, "Tensor
    parallelism for the other families")."""
    what = ("MoE" if cfg.num_experts else "SSM" if cfg.arch_type == "ssm"
            else "hybrid" if cfg.hybrid
            else "encoder-decoder" if cfg.is_encoder_decoder
            else "VLM" if cfg.num_image_tokens
            else None if cfg.arch_type in TP_FAMILIES else cfg.arch_type)
    if what is not None:
        raise NotImplementedError(
            f"{cfg.name or 'this config'} ({what}): {axis} runs the dense "
            f"decoder only; the {what} family waits for ROADMAP §1's item "
            f"'tensor parallelism for the other families'")


def tp_layout(cfg, model: int) -> Dict[str, Optional[int]]:
    """Every parameter leaf of ``cfg`` -> the dim (negative, from the end)
    split over ``model`` ranks, or None: the module docstring's rules.
    With ``model`` 1 every leaf is whole."""
    from repro_torch.models.transformer import param_names, param_shapes
    if model > 1:
        require_tp_family(cfg)
    shapes = param_shapes(cfg)
    heads_ok = cfg.num_heads % model == 0 and cfg.num_kv_heads % model == 0
    axis = _AxisShape(model)
    out: Dict[str, Optional[int]] = {}
    for path, names in param_names(cfg).items():
        shape = shapes[path]
        spec = spec_for(names, shape, mesh=axis) if model > 1 else ()
        dim = next((i for i, a in enumerate(spec) if a == "model"), None)
        if dim is not None and names[dim] in _HEAD_NAMES and not heads_ok:
            dim = None
        out[path] = None if dim is None else dim - len(shape)
    for path in shapes:
        tail = "/".join(path.split("/")[-2:])
        if tail in _QKV_BIAS:
            w = path[:-len(tail)] + _QKV_BIAS[tail]
            out[path] = None if out[w] is None else -1
    return out


def fsdp_layout(cfg, data: int, model: int = 1) -> Dict[str, Optional[int]]:
    """Every parameter leaf of ``cfg`` -> the dim (negative, from the end)
    its ``fsdp`` name splits over ``data`` ranks (``spec_for`` under the
    default rules on a (data, model) mesh), or None: the module
    docstring's rules.  With ``data`` 1 every leaf is whole."""
    from repro_torch.models.transformer import param_names, param_shapes
    if data > 1:
        require_tp_family(cfg, "fsdp over the data axis")
    shapes = param_shapes(cfg)
    axes = _AxisShape(model, data)
    out: Dict[str, Optional[int]] = {}
    for path, names in param_names(cfg).items():
        shape = shapes[path]
        spec = spec_for(names, shape, mesh=axes) if data > 1 else ()
        dim = next((i for i, a in enumerate(spec) if a == "data"), None)
        out[path] = None if dim is None else dim - len(shape)
    return out


def split_of(path: str, layout: Optional[Layout]) -> Optional[int]:
    """The layout's entry for the leaf ``path`` names, where ``path`` is
    the leaf's own or ends in it (``.../layers/attn/wq``); None for a
    path that ends in no leaf of the layout (a step counter) or no
    layout."""
    if layout is None:
        return None
    if path in layout:
        return layout[path]
    parts = path.split("/")
    for i in range(1, len(parts)):
        tail = "/".join(parts[i:])
        if tail in layout:
            return layout[tail]
    return None


def _cut(t, dim: int, index: int, model: int):
    n = t.shape[dim] // model
    if isinstance(t, torch.Tensor):
        return t.narrow(dim, index * n, n)
    return np.take(t, range(index * n, (index + 1) * n), axis=dim)


def shard(flat: Dict[str, object], layout: Optional[Layout], index: int,
          model: int, *, fsdp: Optional[Layout] = None, data_index: int = 0,
          data: int = 1) -> Dict[str, object]:
    """Rank ``index``'s shards of one-process flat parameters (tensors or
    numpy arrays; any path ending in a leaf's): a split leaf's
    ``index``-th of ``model`` contiguous pieces along its dim, copied; a
    whole leaf copied as it is.  With ``fsdp`` (a ``fsdp_layout``) the
    piece is further cut to data rank ``data_index``'s of ``data``
    pieces along its ``fsdp`` dim."""
    out = {}
    for path, t in flat.items():
        piece = t
        dim = split_of(path, layout)
        if dim is not None and model > 1:
            piece = _cut(piece, dim, index, model)
        dim = split_of(path, fsdp)
        if dim is not None and data > 1:
            piece = _cut(piece, dim, data_index, data)
        out[path] = (piece.clone() if isinstance(piece, torch.Tensor)
                     else np.array(piece))
    return out


def _join(parts: List[Dict[str, torch.Tensor]], layout: Optional[Layout]
          ) -> Dict[str, torch.Tensor]:
    out = {}
    for path, t in parts[0].items():
        dim = split_of(path, layout)
        out[path] = t if dim is None or len(parts) == 1 else torch.cat(
            [s[path] for s in parts], dim=dim)
    return out


def gather(shards: List[Dict[str, torch.Tensor]], layout: Optional[Layout],
           *, fsdp: Optional[Layout] = None, data: int = 1
           ) -> Dict[str, torch.Tensor]:
    """Inverse of ``shard``: the ranks' shards (tensors), in rank order
    (data-major: the model ranks of data index 0 first), joined into the
    one-process layout (a whole leaf is rank 0's)."""
    model = len(shards) // data
    rows = [_join(shards[d * model:(d + 1) * model], layout)
            for d in range(data)]
    return _join(rows, fsdp)


# ---------------------------------------------------------------------------
# Serving over the ``model`` axis
# ---------------------------------------------------------------------------

def tp_kv_repeat(cfg, tp: int):
    """Repeat KV heads up to the tensor-parallel degree (the Megatron GQA
    trick), so the decode KV cache shards over ``model``; only where the
    result still divides ``num_heads``.  Archs that cannot (llama4-scout's
    40 heads, hymba's 25) shard the cache's sequence dim instead
    (``serve_layout``'s ``"kv_seq"``)."""
    if cfg.num_kv_heads >= tp or cfg.arch_type == "ssm":
        return cfg
    if tp % cfg.num_kv_heads or cfg.num_heads % tp:
        return cfg
    return dataclasses.replace(cfg, num_kv_heads=tp)


def serve_layout(cfg, model: int) -> Tuple[str, Dict[str, Optional[int]]]:
    """(``"heads"`` or ``"kv_seq"``, the parameter layout) of serving
    ``cfg`` over ``model`` ranks: the module docstring's rules.  The
    layout is ``tp_layout`` of ``tp_kv_repeat(cfg, model)``, the config
    the ranks serve (with ``repeat_kv_heads``' parameters)."""
    rep = tp_kv_repeat(cfg, model)
    heads = rep.num_heads % model == 0 and rep.num_kv_heads % model == 0
    return ("heads" if heads else "kv_seq"), tp_layout(rep, model)


_KV_LEAVES = ("attn/wk", "attn/wv", "attn/bk", "attn/bv")


def repeat_kv_heads(flat: Dict[str, torch.Tensor], cfg,
                    model: int) -> Dict[str, torch.Tensor]:
    """One-process flat parameters of ``cfg`` as those of
    ``tp_kv_repeat(cfg, model)``: each KV head's columns of ``wk`` /
    ``wv`` (and ``bk`` / ``bv``) repeated ``model / num_kv_heads`` times
    in place (``repeat_interleave``), so query head h reads new KV head
    h // (H / model), a copy of its own KV head h // (H / KV).  The other
    leaves are the same tensors; ``flat`` itself where no repeat
    applies."""
    times = tp_kv_repeat(cfg, model).num_kv_heads // cfg.num_kv_heads
    if times == 1:
        return flat
    hd = cfg.resolved_head_dim()
    out = {}
    for path, t in flat.items():
        if "/".join(path.split("/")[-2:]) in _KV_LEAVES:
            heads = t.reshape(*t.shape[:-1], t.shape[-1] // hd, hd)
            t = heads.repeat_interleave(times, dim=-2).flatten(-2)
        out[path] = t
    return out


# the ring cache's leaves and the dim a layout splits them on (from the
# end): k / v (L, B, KV, cap, hd), pos (L, B, cap)
_CACHE_SPLIT = {"heads": {"k": -3, "v": -3},
                "kv_seq": {"k": -2, "v": -2, "pos": -1}}


def shard_cache(cache: dict, mode: str, index: int, model: int) -> dict:
    """Rank ``index``'s part of a one-process static decode cache
    (``init_decode_cache``, ``{"attn": {"k", "v", "pos", "idx"}}``) in
    ``mode``'s layout (``serve_layout``), copied; a ``kv_seq`` part
    records the rank count under ``"kv_seq"``."""
    attn = {}
    for name, t in cache["attn"].items():
        dim = _CACHE_SPLIT[mode].get(name)
        if torch.is_tensor(t):
            t = (t if dim is None else _cut(t, dim, index, model)).clone()
        attn[name] = t
    if mode == "kv_seq":
        attn["kv_seq"] = model
    return dict(cache, attn=attn)


def gather_cache(parts: List[dict]) -> dict:
    """Inverse of ``shard_cache``: the model ranks' caches, in
    model-index order, joined into the one-process cache."""
    attn = dict(parts[0]["attn"])
    mode = "kv_seq" if attn.pop("kv_seq", 1) > 1 else "heads"
    for name, dim in _CACHE_SPLIT[mode].items():
        attn[name] = torch.cat([p["attn"][name] for p in parts], dim=dim)
    return dict(parts[0], attn=attn)
