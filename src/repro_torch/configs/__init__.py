from repro_torch.configs.base import (DiLoCoConfig, ModelConfig,
                                     OptimizerConfig)
from repro_torch.configs.mamba2_13b import CONFIG as MAMBA2_13B
from repro_torch.configs.nanochat_d20 import CONFIG as NANOCHAT_D20
from repro_torch.configs.registry import get_config, get_reduced

__all__ = ["DiLoCoConfig", "MAMBA2_13B", "ModelConfig", "NANOCHAT_D20",
           "OptimizerConfig", "get_config", "get_reduced"]
