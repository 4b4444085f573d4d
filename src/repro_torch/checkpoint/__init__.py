from repro_torch.checkpoint.convert import (load_config, load_pytree,
                                            params_from_numpy,
                                            params_to_numpy)

__all__ = ["load_config", "load_pytree", "params_from_numpy",
           "params_to_numpy"]
