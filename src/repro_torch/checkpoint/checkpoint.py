"""Save parameter trees and model configs in the JAX package's checkpoint
format (``repro/checkpoint/checkpoint.py`` ``save_pytree`` and
``save_config``), so that the JAX ``load_pytree`` / ``load_config`` read
what the port writes, and the port's ``load_pytree`` / ``load_config``
(``convert.py``) read it back.

``save_pytree(tree, path)`` writes ``<path>.npz`` (one array ``a<i>`` per
leaf, in the JAX tree order: dict keys sorted at every level) and
``<path>.json``, a manifest of ``{"key", "path", "dtype", "shape"}`` per
leaf, where ``path`` joins the dict keys with "/" — the port's
``flatten`` paths, equal to the JAX ``_path_str`` paths.
``save_config(cfg, path)`` writes the ModelConfig as ``<path>.cfg.json``.
Every file is written atomically: a temp file in the same directory,
fsync'd, then ``os.replace``d over the final name, so a crash mid-save
leaves the old file or nothing, never a torn one.

Run checkpoints (``save_run_checkpoint`` and the readers below) use the
JAX package's layout, file names and manifest keys; what they store is
the port's training state, whose leaves ``_leaves`` walks: nested dicts
(keys sorted), lists of the K workers' flat dicts (by index),
``NamedTuple``s such as ``DiLoCoState`` and ``OuterState`` (by field
name), ``None`` (no leaf) and 0-d tensors such as ``inner_step``.
bfloat16 leaves are stored as their uint16 bits, float8 leaves (an
async-gossip board's codes) as their uint8 bits: numpy has neither
type."""
from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.checkpoint.convert import load_pytree


def _atomic_bytes(path: str, write_fn) -> None:
    """Write a file atomically: ``write_fn(handle)`` fills a temp file in
    the same directory, which is then fsync'd and ``os.replace``d over
    ``path``.  A crash mid-write leaves either the old file or nothing —
    never a torn file at the final name."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, prefix=os.path.basename(path) + ".tmp.")
    try:
        with os.fdopen(fd, "wb") as f:
            write_fn(f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def _json_default(o):
    """Numpy scalars and 0-d tensors (loss histories, eval metrics) ->
    python scalars.  ``repr``-based float round-trip is exact, so
    histories survive a save/load cycle bitwise."""
    if isinstance(o, torch.Tensor) and o.dim() == 0:
        return o.item()
    if hasattr(o, "item") and np.ndim(o) == 0:
        return o.item()
    raise TypeError(f"not JSON serializable: {type(o).__name__}")


def _atomic_json(path: str, obj) -> None:
    _atomic_bytes(path, lambda f: f.write(
        json.dumps(obj, indent=1, default=_json_default).encode("utf-8")))


def _join(prefix: str, key) -> str:
    return f"{prefix}/{key}" if prefix else str(key)


def _children(tree: Any) -> Optional[List[Tuple[str, Any]]]:
    """(key, child) pairs of an inner node in the JAX flattening order —
    dict keys sorted, list / tuple entries by index, ``NamedTuple`` fields
    by name — or None for a leaf."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [(f, getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, (list, tuple)):
        return [(str(i), x) for i, x in enumerate(tree)]
    return None


def _leaves(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """(path, leaf) pairs of a tree, in the JAX flattening order; ``None``
    has no leaves, as in JAX."""
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    out: List[Tuple[str, Any]] = []
    for k, v in kids:
        out += _leaves(v, _join(prefix, k))
    return out


# torch dtypes numpy lacks: (their bits as a torch dtype, the same as a
# numpy dtype, the numpy dtype stored)
_AS_BITS = {torch.bfloat16: (torch.int16, np.int16, np.uint16),
            torch.float8_e4m3fn: (torch.uint8, np.uint8, np.uint8),
            torch.float8_e5m2: (torch.uint8, np.uint8, np.uint8)}


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        if leaf.dtype in _AS_BITS:
            bits, _, stored = _AS_BITS[leaf.dtype]
            return leaf.view(bits).numpy().view(stored)
        return leaf.numpy()
    return np.asarray(leaf)


def _device_leaf(arr: np.ndarray, like: torch.Tensor, path: str
                 ) -> torch.Tensor:
    """A fresh tensor holding ``arr`` with ``like``'s dtype on its device."""
    if tuple(arr.shape) != tuple(like.shape):
        raise ValueError(f"shape mismatch at {path}: checkpoint "
                         f"{arr.shape} vs {tuple(like.shape)}")
    if like.dtype in _AS_BITS and arr.dtype == _AS_BITS[like.dtype][2]:
        t = torch.from_numpy(arr.view(_AS_BITS[like.dtype][1])).view(
            like.dtype)
    else:
        t = torch.from_numpy(arr)
    return t.to(device=like.device, dtype=like.dtype)


def _restore(template: Any, by_path: Dict[str, np.ndarray],
             prefix: str = "") -> Any:
    """``template``'s structure with every tensor leaf replaced by a fresh
    tensor of the same dtype and device holding the checkpoint's array at
    its path."""
    if template is None:
        return None
    kids = _children(template)
    if kids is None:
        if prefix not in by_path:
            raise KeyError(f"checkpoint missing leaf {prefix}")
        arr = by_path[prefix]
        if isinstance(template, torch.Tensor):
            return _device_leaf(arr, template, prefix)
        return arr
    vals = {k: _restore(v, by_path, _join(prefix, k)) for k, v in kids}
    if isinstance(template, dict):
        return {k: vals[str(k)] for k in template}
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(**vals)
    return type(template)(vals[str(i)] for i in range(len(template)))


def save_pytree(tree: Dict[str, Any], path: str) -> None:
    """Save a nested dict of tensors (or arrays) to <path>.npz (+
    <path>.json manifest), both written atomically."""
    arrays, manifest = {}, []
    for i, (p, leaf) in enumerate(_leaves(tree)):
        key = f"a{i}"
        arrays[key] = _host(leaf)
        manifest.append({"key": key, "path": p,
                         "dtype": str(arrays[key].dtype),
                         "shape": list(arrays[key].shape)})
    _atomic_bytes(path + ".npz", lambda f: np.savez(f, **arrays))
    _atomic_json(path + ".json", manifest)


def save_config(cfg, path: str) -> None:
    """Write the ModelConfig next to the checkpoint as <path>.cfg.json."""
    _atomic_json(path + ".cfg.json", dataclasses.asdict(cfg))


# ---------------------------------------------------------------------------
# Run checkpoints: crash-consistent training snapshots with a manifest
# ---------------------------------------------------------------------------
#
# Layout inside a checkpoint dir, per saved step (the JAX package's):
#
#   ckpt_00000012.state.npz / .state.json    — the full trainer state
#   ckpt_00000012.extras.npz / .extras.json  — runner-private tensors (the
#                                              codec's error-feedback
#                                              residual), only when any
#   ckpt_00000012.manifest.json              — written LAST, atomically
#
# The manifest names every file the checkpoint needs plus the data
# cursor (batches are pure functions of the step index, so the cursor IS
# the step), the runner's JSON metadata and the recorded history.  The
# manifest lands last via os.replace, so its existence implies a complete
# checkpoint; readers still check the files it names and skip the entry
# when any is missing, so a torn write degrades to "resume from the
# previous checkpoint", never to loading garbage.

_MANIFEST_FORMAT = 1


def save_run_checkpoint(ckpt_dir: str, step: int, state: Any,
                        extras_arrays: Any = None,
                        extras_meta: Optional[Dict] = None,
                        history: Optional[Dict] = None,
                        meta: Optional[Dict] = None,
                        before_manifest=None) -> str:
    """Write one crash-consistent training checkpoint; returns the
    manifest path.  Tensors on the card are copied to the host here.
    ``before_manifest()`` runs after the arrays are written and before
    the manifest that marks them complete (the ranks of a process mesh
    meet there)."""
    os.makedirs(ckpt_dir, exist_ok=True)
    stem = os.path.join(ckpt_dir, f"ckpt_{step:08d}")
    files = {"state": os.path.basename(stem) + ".state"}
    save_pytree(state, stem + ".state")
    if extras_arrays is not None and _leaves(extras_arrays):
        save_pytree(extras_arrays, stem + ".extras")
        files["extras"] = os.path.basename(stem) + ".extras"
    manifest = {
        "format": _MANIFEST_FORMAT,
        "step": step,
        "data_cursor": step,
        "files": files,
        "extras_meta": extras_meta or {},
        "history": history or {},
        "meta": meta or {},
    }
    if before_manifest is not None:
        before_manifest()
    _atomic_json(stem + ".manifest.json", manifest)
    return stem + ".manifest.json"


def _manifest_complete(ckpt_dir: str, manifest: Dict) -> bool:
    for base in manifest.get("files", {}).values():
        stem = os.path.join(ckpt_dir, base)
        if not (os.path.exists(stem + ".npz")
                and os.path.exists(stem + ".json")):
            return False
    return True


def list_run_checkpoints(ckpt_dir: str) -> List[Tuple[int, str]]:
    """(step, manifest_path) for every COMPLETE checkpoint, ascending."""
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in sorted(os.listdir(ckpt_dir)):
        if not name.endswith(".manifest.json"):
            continue
        path = os.path.join(ckpt_dir, name)
        try:
            with open(path) as f:
                manifest = json.load(f)
        except (OSError, json.JSONDecodeError):
            continue
        if manifest.get("format") != _MANIFEST_FORMAT:
            continue
        if not _manifest_complete(ckpt_dir, manifest):
            continue                        # torn write: skip, don't crash
        out.append((int(manifest["step"]), path))
    out.sort()
    return out


def latest_run_checkpoint(ckpt_dir: str) -> Optional[Dict]:
    """The newest complete checkpoint's manifest (with ``_dir`` attached),
    or None when the directory has none."""
    entries = list_run_checkpoints(ckpt_dir)
    if not entries:
        return None
    _, path = entries[-1]
    with open(path) as f:
        manifest = json.load(f)
    manifest["_dir"] = ckpt_dir
    return manifest


# the state's per-worker lists (one entry a worker)
_WORKER_LISTS = ("worker_params", "inner_opt")


def _kept(path: str, rows) -> bool:
    """Whether a process holding workers ``rows`` reads the state array at
    ``path`` (another worker's list entry it does not)."""
    head, _, rest = path.partition("/")
    return head not in _WORKER_LISTS or int(rest.partition("/")[0]) in rows


def _keep_rows(by_path: Dict[str, np.ndarray], rows, extras: bool
               ) -> Dict[str, np.ndarray]:
    """The checkpoint's arrays as a process holding workers ``rows`` sees
    them: the state's per-worker list entries ``rows[i]`` renumbered
    ``i``; every extras array (per-worker (K, ...) stacks) cut to those
    rows."""
    if extras:
        return {p: a[list(rows)] for p, a in by_path.items()}
    out = {}
    for p, a in by_path.items():
        head, _, rest = p.partition("/")
        if head in _WORKER_LISTS:
            w, _, tail = rest.partition("/")
            if int(w) not in rows:
                continue
            p = "/".join(x for x in (head, str(rows.index(int(w))), tail)
                         if x)
        out[p] = a
    return out


def load_run_checkpoint(manifest: Dict, state_template: Any,
                        extras_template: Any = None, rows=None, cut=None
                        ) -> Tuple[Any, Optional[Any]]:
    """Restore (state, extras) from a manifest returned by
    ``latest_run_checkpoint``, into fresh tensors with the templates'
    structure, dtypes and devices (the templates' tensors are only read
    for those).  ``extras_template`` None (or an entry the checkpoint
    lacks) yields extras None.  ``rows`` (a rank of a process mesh: the
    workers it holds) keeps those workers' rows of the one-process
    layout, whatever world size wrote it; ``cut`` (``{path: array}`` ->
    the same, a rank of a model axis: ``models.sharding.shard``) cuts the
    arrays to the rank's shards before they are restored."""
    ckpt_dir = manifest["_dir"]
    files = manifest["files"]
    if rows is None:
        by_path = load_pytree(os.path.join(ckpt_dir, files["state"]))
    else:
        rows = tuple(rows)
        by_path = _keep_rows(load_pytree(
            os.path.join(ckpt_dir, files["state"]),
            keep=lambda p: _kept(p, rows)), rows, extras=False)
    if cut is not None:
        by_path = cut(by_path)
    state = _restore(state_template, by_path)
    extras = None
    if extras_template is not None and "extras" in files:
        by_path = load_pytree(os.path.join(ckpt_dir, files["extras"]))
        if rows is not None:
            by_path = _keep_rows(by_path, rows, extras=True)
        if cut is not None:
            by_path = cut(by_path)
        extras = _restore(extras_template, by_path)
    return state, extras
