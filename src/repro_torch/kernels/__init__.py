"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version.  A wrapper runs the plain version for CPU tensors and launches
its CUDA kernel (or raises) for CUDA tensors.  ``launches`` counts kernel
launches per name since ``reset_launches()``."""
from repro_torch.kernels._build import launches, reset_launches

KERNELS = ("rmsnorm", "rmsnorm_residual", "paged_decode", "paged_verify",
           "flash_fwd", "flash_bwd", "fused_adamw", "rmsnorm_bwd",
           "paged_decode_dequant", "paged_verify_dequant",
           "paged_decode_fp8", "paged_verify_fp8", "quantize_ef",
           "dequantize", "ssd", "ring_decode", "flash_fwd_fp8")

__all__ = ["KERNELS", "launches", "reset_launches"]
