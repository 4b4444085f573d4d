"""Abstract train / serve states and their logical names (the JAX
package's ``launch/state.py``).

Everything here is built on the ``meta`` device: shapes and dtypes, no
storage, so the dry run describes a 100B-parameter state without
allocating it.  Names are tuples of logical dim names, one per dim
(``models.transformer.param_names``), which ``models.sharding.spec_for``
resolves on a mesh; ``state_bytes`` sums the per-device bytes of a state
under its names, and ``live_state_bytes`` the bytes a live state holds,
which the dry run of a runtime mesh predicts
(``launch.dryrun_lib.runtime_state_bytes``).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import (DiLoCoConfig, ModelConfig,
                                      OptimizerConfig)
from repro_torch.models.sharding import local_shape, spec_for
# the reference keeps tp_kv_repeat here; the port's lives beside the
# serving layout that reads it
from repro_torch.models.sharding import tp_kv_repeat  # noqa: F401
from repro_torch.models.transformer import param_names, param_shapes
from repro_torch.models.layers import torch_dtype
from repro_torch.optim import nanochat_optimizer


def _is_names(x) -> bool:
    """A names leaf: a plain tuple of str / None (not a NamedTuple)."""
    return (isinstance(x, tuple) and not hasattr(x, "_fields")
            and all(n is None or isinstance(n, str) for n in x))


def _map_with_path(fn, tree, path: str = ""):
    """``fn(path, leaf)`` over the tensor leaves of nested dicts, lists and
    (named) tuples; other leaves (ints) map to ()."""
    if torch.is_tensor(tree):
        return fn(path, tree)
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, f"{path}/{k}" if path else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        keys = getattr(tree, "_fields", range(len(tree)))
        out = [_map_with_path(fn, v, f"{path}/{k}" if path else str(k))
               for k, v in zip(keys, tree)]
        return type(tree)(*out) if hasattr(tree, "_fields") \
            else type(tree)(out)
    return ()


def _map_names(fn, names, tree):
    """``fn(names_leaf, leaf)`` over a names tree and the tree it names."""
    if _is_names(names):
        return fn(names, tree)
    if isinstance(names, dict):
        return {k: _map_names(fn, v, tree[k]) for k, v in names.items()}
    out = [_map_names(fn, n, t) for n, t in zip(names, tree)]
    return type(names)(*out) if hasattr(names, "_fields") \
        else type(names)(out)


def _leaves(names, tree):
    """(names leaf, tensor leaf) pairs of a names tree and its tree."""
    out = []
    _map_names(lambda n, t: out.append((n, t)) if torch.is_tensor(t)
               else None, names, tree)
    return out


# ---------------------------------------------------------------------------
# Logical names of the non-parameter trees
# ---------------------------------------------------------------------------

def opt_state_names(state, names: Dict[str, Tuple]) -> Any:
    """Optimizer-state names: a leaf whose path ends in a parameter's path
    takes that parameter's names (when the ranks agree); scalars and
    0-size leaves, and anything else, are unsharded."""
    def assign(path, leaf):
        if leaf.dim() == 0 or tuple(leaf.shape) == (0,):
            return (None,) * leaf.dim()
        for key, n in names.items():
            if path.endswith(key) and len(n) == leaf.dim():
                return n
        return (None,) * leaf.dim()
    return _map_with_path(assign, state)


def decode_cache_names(cache) -> Any:
    """Names of a stacked decode cache (``init_decode_cache``), by leaf
    name, in the port's layouts: attention K / V (L, B, KV, cap, hd), the
    cross cache alike, ``pos`` (L, B, cap), the mamba ``conv`` (L, B, W-1,
    conv_dim) and ``ssm`` (L, B, H, N, P).  A model rank's part of the
    ring cache (``init_decode_cache(..., mesh=)``) has the shapes these
    names resolve to over ``model`` under the serve step's rules
    (``kv_seq`` on ``model`` where the KV heads do not divide)."""
    by_leaf = {"k": ("stack", "batch", "kv_heads", "kv_seq", None),
               "v": ("stack", "batch", "kv_heads", "kv_seq", None),
               "pos": ("stack", "batch", "kv_seq"),
               "conv": ("stack", "batch", None, "heads"),
               "ssm": ("stack", "batch", "heads", None, None)}
    return _map_with_path(
        lambda path, leaf: by_leaf.get(path.split("/")[-1],
                                       (None,) * leaf.dim()), cache)


def shardings_from_names(names_tree, tree, mesh) -> Any:
    """Names + (meta) tensors -> the per-leaf partition spec on ``mesh``,
    with the divisibility fallback per dim."""
    return _map_names(lambda n, t: spec_for(n, tuple(t.shape), mesh)
                      if torch.is_tensor(t) else (), names_tree, tree)


def add_leading(names_tree, name: str = "pod") -> Any:
    """Prepend a logical dim (worker stacking) to every leaf's names."""
    return _map_names(lambda n, _: (name,) + tuple(n), names_tree,
                      names_tree)


def live_state_bytes(*trees) -> int:
    """Bytes of the tensors a live state holds (nested dicts, lists and
    named tuples of tensors; several trees together), each storage
    counted once: a state whose entries share a tensor holds it once."""
    seen, total = set(), 0

    def count(path, t):
        nonlocal total
        key = (t.device, t.untyped_storage().data_ptr())
        if key not in seen:
            seen.add(key)
            total += t.untyped_storage().nbytes()
        return ()

    for tree in trees:
        _map_with_path(count, tree)
    return total


def state_bytes(tree, names_tree, mesh) -> int:
    """Bytes one device holds of ``tree`` under its names on ``mesh``."""
    total = 0
    for n, t in _leaves(names_tree, tree):
        shard = local_shape(tuple(t.shape), spec_for(n, tuple(t.shape), mesh),
                            mesh)
        count = 1
        for d in shard:
            count *= d
        total += count * t.element_size()
    return total


# ---------------------------------------------------------------------------
# Abstract states
# ---------------------------------------------------------------------------

def abstract_params(cfg: ModelConfig) -> Tuple[Dict[str, torch.Tensor],
                                               Dict[str, Tuple]]:
    """(flat ``meta`` parameters in the config's parameter dtype, their
    names)."""
    dt = torch_dtype(cfg.param_dtype)
    return ({k: torch.empty(s, dtype=dt, device="meta")
             for k, s in param_shapes(cfg).items()}, param_names(cfg))


def abstract_train_state(cfg: ModelConfig, opt_cfg: OptimizerConfig
                         ) -> Tuple[Any, Any]:
    """(the DDP train state on ``meta``, its names)."""
    from repro_torch.core.ddp import DDPState
    params, names = abstract_params(cfg)
    opt = nanochat_optimizer(opt_cfg).init(params)
    state = DDPState(params=params, opt=opt,
                     step=torch.empty((), dtype=torch.int32, device="meta"))
    return state, DDPState(params=names, opt=opt_state_names(opt, names),
                           step=())


def _stacked(tree, k: int):
    return _map_with_path(lambda _, t: torch.empty(
        (k,) + tuple(t.shape), dtype=t.dtype, device="meta"), tree)


def abstract_diloco_state(cfg: ModelConfig, opt_cfg: OptimizerConfig,
                          dcfg: DiLoCoConfig) -> Tuple[Any, Any]:
    """(the DiLoCo state on ``meta``, its names).  The K workers' parameters
    and inner optimizer states are stacked on a leading (K, ...) dim named
    ``pod``, as the reference's state is: one row a rank on a process mesh
    (where the runtime holds that row as its own dict)."""
    from repro_torch.core.diloco import DiLoCoState
    from repro_torch.core.outer_opt import OuterState, init_outer_state
    params, names = abstract_params(cfg)
    inner = nanochat_optimizer(opt_cfg).init(params)
    outer = init_outer_state(params)
    k = dcfg.num_workers
    state = DiLoCoState(global_params=params, outer=outer,
                        worker_params=_stacked(params, k),
                        inner_opt=_stacked(inner, k),
                        inner_step=torch.empty((), dtype=torch.int32,
                                               device="meta"))
    state_names = DiLoCoState(
        global_params=names,
        outer=OuterState(v=opt_state_names(outer.v, names), t=()),
        worker_params=add_leading(names, "pod"),
        inner_opt=add_leading(opt_state_names(inner, names), "pod"),
        inner_step=())
    return state, state_names
