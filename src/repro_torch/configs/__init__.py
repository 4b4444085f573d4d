from repro_torch.configs.base import (DECODE_32K, LONG_500K, PREFILL_32K,
                                     SHAPES, TRAIN_4K, DiLoCoConfig,
                                     ModelConfig, OptimizerConfig,
                                     ShapeConfig)
from repro_torch.configs.command_r_plus_104b import \
    CONFIG as COMMAND_R_PLUS_104B
from repro_torch.configs.hymba_15b import CONFIG as HYMBA_15B
from repro_torch.configs.internvl2_26b import CONFIG as INTERNVL2_26B
from repro_torch.configs.llama4_scout_17b_a16e import \
    CONFIG as LLAMA4_SCOUT_17B_A16E
from repro_torch.configs.mamba2_13b import CONFIG as MAMBA2_13B
from repro_torch.configs.mistral_large_123b import \
    CONFIG as MISTRAL_LARGE_123B
from repro_torch.configs.mixtral_8x7b import CONFIG as MIXTRAL_8X7B
from repro_torch.configs.nanochat_d20 import CONFIG as NANOCHAT_D20
from repro_torch.configs.nemotron4_15b import CONFIG as NEMOTRON4_15B
from repro_torch.configs.qwen15_05b import CONFIG as QWEN15_05B
from repro_torch.configs.registry import (ALL_IDS, ARCH_IDS,
                                          LONG_CONTEXT_WINDOW,
                                          decode_cache_capacity, get_config,
                                          get_reduced, input_specs,
                                          long_context_variant,
                                          shape_by_name)
from repro_torch.configs.seamless_m4t_medium import \
    CONFIG as SEAMLESS_M4T_MEDIUM

__all__ = ["ALL_IDS", "ARCH_IDS", "COMMAND_R_PLUS_104B", "DECODE_32K",
           "DiLoCoConfig", "HYMBA_15B", "INTERNVL2_26B", "LONG_500K",
           "LONG_CONTEXT_WINDOW", "LLAMA4_SCOUT_17B_A16E", "MAMBA2_13B",
           "MISTRAL_LARGE_123B", "MIXTRAL_8X7B", "ModelConfig",
           "NANOCHAT_D20", "NEMOTRON4_15B", "OptimizerConfig", "PREFILL_32K",
           "QWEN15_05B", "SEAMLESS_M4T_MEDIUM", "SHAPES", "ShapeConfig",
           "TRAIN_4K", "decode_cache_capacity", "get_config", "get_reduced",
           "input_specs", "long_context_variant", "shape_by_name"]
