from repro_torch.kernels.fused_adamw.ops import fused_adamw_update
from repro_torch.kernels.fused_adamw.ref import fused_adamw_plain

__all__ = ["fused_adamw_plain", "fused_adamw_update"]
