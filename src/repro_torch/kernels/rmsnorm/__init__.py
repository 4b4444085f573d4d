from repro_torch.kernels.rmsnorm.ops import (rmsnorm, rmsnorm_bwd,
                                             rmsnorm_residual)
from repro_torch.kernels.rmsnorm.ref import (rmsnorm_bwd_plain,
                                              rmsnorm_plain,
                                              rmsnorm_residual_plain)

__all__ = ["rmsnorm", "rmsnorm_bwd", "rmsnorm_bwd_plain", "rmsnorm_residual",
           "rmsnorm_plain", "rmsnorm_residual_plain"]
