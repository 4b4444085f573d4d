from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                     flash_bwd, flash_fwd)
from repro_torch.kernels.flash_attention.ref import (
    flash_attention_bwd_plain, flash_attention_fp8_plain,
    flash_attention_plain)

__all__ = ["flash_attention", "flash_attention_bwd_plain",
           "flash_attention_fp8_plain", "flash_attention_plain", "flash_bwd",
           "flash_fwd"]
