"""The CLIs (``serve``, ``train``) and the host-side comm simulator
(``comm_sim``), whose comm-model names the package exports as the JAX
package's ``repro.launch`` does."""
from repro_torch.launch.comm_sim import (CommModel, default_comm_model,
                                         modeled_step_time, simulate_schedule)

__all__ = ["CommModel", "default_comm_model", "modeled_step_time",
           "simulate_schedule"]
