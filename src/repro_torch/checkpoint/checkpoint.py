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
leaves the old file or nothing, never a torn one."""
from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from typing import Any, Dict, List, Tuple

import numpy as np
import torch


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
    """Numpy scalars (loss histories, eval metrics) -> python scalars.
    ``repr``-based float round-trip is exact, so histories survive a
    save/load cycle bitwise."""
    if hasattr(o, "item") and np.ndim(o) == 0:
        return o.item()
    raise TypeError(f"not JSON serializable: {type(o).__name__}")


def _atomic_json(path: str, obj) -> None:
    _atomic_bytes(path, lambda f: f.write(
        json.dumps(obj, indent=1, default=_json_default).encode("utf-8")))


def _leaves(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """(path, leaf) pairs of a nested dict, in the JAX flattening order
    (dict keys sorted at every level)."""
    if not isinstance(tree, dict):
        return [(prefix, tree)]
    out: List[Tuple[str, Any]] = []
    for k in sorted(tree):
        out += _leaves(tree[k], f"{prefix}/{k}" if prefix else str(k))
    return out


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


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
