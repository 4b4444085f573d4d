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
which has no partitioner to hint: the port's models run whole on each
rank and never call one, so there is none here.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional, Sequence, Tuple, Union

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
