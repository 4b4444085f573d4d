"""Shared fixtures for the PyTorch-port tests: one set of parameters and
inputs, made once, fed to the JAX package (the reference) and to the port
(``repro_torch``) through numpy."""
import dataclasses

import jax
import numpy as np

from repro.checkpoint.checkpoint import _path_str
from repro_torch.checkpoint import params_from_numpy
from repro_torch.configs import ModelConfig as PortConfig

RAGGED = [[5, 6, 7], [1, 2, 3, 4, 5, 6, 7, 8, 9, 10], [2, 9], [7] * 17,
          [4, 4, 4, 4, 4], [11, 3], [1] * 30, [8]]


def port_cfg(cfg) -> PortConfig:
    """The port's ModelConfig with every field of a JAX-package config."""
    return PortConfig(**dataclasses.asdict(cfg))


def jax_flat(params) -> dict:
    """JAX parameter tree -> {checkpoint-manifest path: ndarray}."""
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    return {_path_str(p): np.asarray(leaf) for p, leaf in flat}


def port_params(cfg, params):
    """The port's parameter tree (CPU) holding the same numbers."""
    return params_from_numpy(jax_flat(params), port_cfg(cfg), "cpu")
