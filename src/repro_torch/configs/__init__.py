from repro_torch.configs.base import (DiLoCoConfig, ModelConfig,
                                     OptimizerConfig)
from repro_torch.configs.nanochat_d20 import CONFIG as NANOCHAT_D20

__all__ = ["DiLoCoConfig", "ModelConfig", "NANOCHAT_D20", "OptimizerConfig"]
