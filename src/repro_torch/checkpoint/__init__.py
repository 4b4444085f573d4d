from repro_torch.checkpoint.checkpoint import (latest_run_checkpoint,
                                              list_run_checkpoints,
                                              load_run_checkpoint,
                                              save_config, save_pytree,
                                              save_run_checkpoint)
from repro_torch.checkpoint.convert import (load_config, load_pytree,
                                            params_from_numpy,
                                            params_to_numpy)

__all__ = ["latest_run_checkpoint", "list_run_checkpoints", "load_config",
           "load_pytree", "load_run_checkpoint", "params_from_numpy",
           "params_to_numpy", "save_config", "save_pytree",
           "save_run_checkpoint"]
