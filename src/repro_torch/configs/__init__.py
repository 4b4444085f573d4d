from repro_torch.configs.base import (DiLoCoConfig, ModelConfig,
                                     OptimizerConfig)
from repro_torch.configs.command_r_plus_104b import \
    CONFIG as COMMAND_R_PLUS_104B
from repro_torch.configs.mamba2_13b import CONFIG as MAMBA2_13B
from repro_torch.configs.mistral_large_123b import \
    CONFIG as MISTRAL_LARGE_123B
from repro_torch.configs.nanochat_d20 import CONFIG as NANOCHAT_D20
from repro_torch.configs.nemotron4_15b import CONFIG as NEMOTRON4_15B
from repro_torch.configs.qwen15_05b import CONFIG as QWEN15_05B
from repro_torch.configs.registry import ALL_IDS, get_config, get_reduced

__all__ = ["ALL_IDS", "COMMAND_R_PLUS_104B", "DiLoCoConfig", "MAMBA2_13B",
           "MISTRAL_LARGE_123B", "ModelConfig", "NANOCHAT_D20",
           "NEMOTRON4_15B", "OptimizerConfig", "QWEN15_05B", "get_config",
           "get_reduced"]
