from repro_torch.configs.base import ModelConfig
from repro_torch.configs.nanochat_d20 import CONFIG as NANOCHAT_D20

__all__ = ["ModelConfig", "NANOCHAT_D20"]
