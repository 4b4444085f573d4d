"""Load JAX-package checkpoints into the port, without JAX.

The JAX package saves a parameter tree as ``<path>.npz`` plus a
``<path>.json`` manifest of ``{"key", "path", "dtype", "shape"}`` per leaf,
where ``path`` joins the tree's dict keys with "/" (``embed/table``,
``layers/attn/wq``, ...), and the model config as ``<path>.cfg.json``.
The port keeps that tree and leaf layout (``(d_in, d_out)`` matrices,
stacked ``(L, ...)`` layer leaves), so loading is a lookup by path with
no transposes."""
from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import torch_dtype
from repro_torch.models.transformer import (Params, flatten, param_shapes,
                                            unflatten)


def load_pytree(path: str) -> Dict[str, np.ndarray]:
    """``<path>.npz`` + ``<path>.json`` -> {manifest path: array}."""
    with open(path + ".json") as f:
        manifest = json.load(f)
    with np.load(path + ".npz") as data:
        return {m["path"]: data[m["key"]] for m in manifest}


def params_from_numpy(flat: Dict[str, np.ndarray], cfg: ModelConfig,
                      device="cpu") -> Params:
    """Build the port's parameter tree from {manifest path: array}.
    Every leaf ``cfg`` needs must be present with its exact shape; leaves
    it does not need are refused too, so a config/checkpoint mismatch
    cannot load silently."""
    want = param_shapes(cfg)
    missing = sorted(set(want) - set(flat))
    extra = sorted(set(flat) - set(want))
    if missing or extra:
        raise KeyError(f"checkpoint does not match {cfg.name}: missing "
                       f"{missing}, unexpected {extra}")
    dt = torch_dtype(cfg.param_dtype)
    out = {}
    for path, shape in want.items():
        arr = np.asarray(flat[path])
        if tuple(arr.shape) != shape:
            raise ValueError(f"shape mismatch at {path}: checkpoint "
                             f"{arr.shape} vs {shape}")
        out[path] = torch.tensor(arr, dtype=dt, device=device)
    return unflatten(out)


def params_to_numpy(params: Params) -> Dict[str, np.ndarray]:
    """The inverse of :func:`params_from_numpy`: {manifest path: array}
    (host copies, float32 leaves as float32)."""
    return {path: leaf.detach().cpu().numpy()
            for path, leaf in flatten(params).items()}


def load_config(path: str) -> Optional[ModelConfig]:
    """The ModelConfig saved beside a checkpoint (``<path>.cfg.json``), or
    None when the checkpoint has none."""
    meta = path + ".cfg.json"
    if not os.path.exists(meta):
        return None
    with open(meta) as f:
        d = json.load(f)
    if "window_pattern" in d:                 # tuples round-trip as lists
        d["window_pattern"] = tuple(d["window_pattern"])
    return ModelConfig(**d)
