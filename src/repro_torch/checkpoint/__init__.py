from repro_torch.checkpoint.checkpoint import save_config, save_pytree
from repro_torch.checkpoint.convert import (load_config, load_pytree,
                                            params_from_numpy,
                                            params_to_numpy)

__all__ = ["load_config", "load_pytree", "params_from_numpy",
           "params_to_numpy", "save_config", "save_pytree"]
