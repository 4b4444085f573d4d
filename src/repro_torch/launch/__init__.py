"""The CLIs (``serve``, ``train``, ``dryrun``), the host-side comm
simulator (``comm_sim``), the meshes (``mesh``: the production meshes'
shapes and the H100 constants, as the JAX package's ``repro.launch``
exports them, and the process mesh of the runtime) and the launch layer
(``collectives``, ``state``, ``steps``, ``analytic``, ``dryrun_lib``)."""
from repro_torch.launch.comm_sim import (CommModel, default_comm_model,
                                         modeled_step_time, simulate_schedule)
from repro_torch.launch.mesh import (DCN_BW, HBM_BW, HBM_PER_CHIP, ICI_BW,
                                     NVLINK_BW, PEAK_FLOPS_BF16,
                                     make_host_mesh, make_production_mesh)

__all__ = ["make_production_mesh", "make_host_mesh", "PEAK_FLOPS_BF16",
           "HBM_BW", "ICI_BW", "NVLINK_BW", "DCN_BW", "HBM_PER_CHIP",
           "CommModel", "simulate_schedule", "modeled_step_time",
           "default_comm_model"]
